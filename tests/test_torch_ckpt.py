"""Checkpoints across the two packages: the port names its variables as
the JAX package's `flatten_state` does, a checkpoint written by either
restores bit for bit in the other, and the port's example writes a series
the JAX package reads. Then the port's CheckpointManager, case by case as
the JAX package's tests hold its own, and across the packages. Last, model
and train-state trees: the port's per-layer lists are checkpointed as the
JAX package's stacked variables, so trainers and the serve launcher of
either package resume from the other's checkpoints."""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.core.bp_engine import BpReader as JBpReader
from repro.core.bp_engine import EngineConfig as JEngineConfig
from repro.pic import simulation as jsim
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core import EngineConfig
from repro_torch.core.darshan import CTR, MONITOR
from repro_torch.examples import pic_simulation
from repro_torch.pic import simulation as sim
from repro_torch.pic.convert import state_from_numpy, state_to_numpy

CFG = jsim.PicConfig(n_cells=64, capacity=1024, n_electrons=512,
                     n_ions=512, n_neutrals=512, rate_R=0.5, dt=1e-2)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    MONITOR.reset()
    yield
    torch.set_num_threads(n)


def _jax_state():
    state = jsim.init_sim(CFG, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in jckpt.flatten_state(state._asdict()).items()}
    return state, flat


def test_variable_names_match_jax_flatten_state():
    jstate, flat = _jax_state()
    tstate = state_from_numpy(flat, "cpu")
    names = list(ckpt.flatten_state(tstate._asdict()))
    assert names == list(jckpt.flatten_state(jstate._asdict()))
    assert names[:6] == ["electrons/.x", "electrons/.v", "electrons/.w",
                         "electrons/.alive", "electrons/.charge",
                         "electrons/.mass"]
    assert names[-5:] == ["neutrals/.mass", "step", "total_ionizations",
                          "wall_flux_e", "wall_flux_i"]
    assert "key" in names
    back = ckpt.unflatten_like(tstate._asdict(),
                               ckpt.flatten_state(tstate._asdict()))
    assert back["electrons"].x is tstate.electrons.x
    assert isinstance(back["ions"], type(tstate.ions))


def test_jax_checkpoint_restores_in_port(tmpdir_path):
    jstate, flat = _jax_state()
    jckpt.save_checkpoint(tmpdir_path, jstate._asdict(), 3, n_io_ranks=4,
                          engine_config=JEngineConfig(codec="blosc"))
    like = sim.init_sim(CFG, 9, device="cpu")._asdict()
    back, step = ckpt.restore_checkpoint(tmpdir_path, like)
    assert step == 3
    got = state_to_numpy(sim.PicState(**back))
    for k, v in flat.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert isinstance(back["electrons"].charge, float)


@pytest.mark.parametrize("device_compress,async_io",
                         [(False, False), (True, False), (True, True)])
def test_port_checkpoint_restores_in_jax(tmpdir_path, device_compress,
                                         async_io):
    jstate, flat = _jax_state()
    tstate = sim.pic_run_chunk(state_from_numpy(flat, "cpu"), CFG, 2)
    ckpt.save_checkpoint(tmpdir_path, tstate._asdict(), 2, n_io_ranks=4,
                         engine_config=EngineConfig(codec="blosc"),
                         device_compress=device_compress, async_io=async_io)
    if device_compress:     # x, w, alive (4C) and v (12C) a species + key
        expect = 3 * 24 * CFG.capacity + 8
        assert MONITOR.report()["total"][CTR.COMPRESS_DEVICE_BYTES] == expect
    like = jax.tree_util.tree_map(np.asarray, jstate._asdict())
    back, step = jckpt.restore_checkpoint(tmpdir_path, like)
    assert step == 2
    want = state_to_numpy(tstate)
    got = {k: np.asarray(v)
           for k, v in jckpt.flatten_state(back).items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # and the port restores its own checkpoint bit for bit
    tback, _ = ckpt.restore_checkpoint(tmpdir_path, tstate._asdict())
    for k, v in state_to_numpy(sim.PicState(**tback)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_restart_from_checkpoint_is_deterministic(tmpdir_path):
    state = sim.pic_run_chunk(sim.init_sim(CFG, 1, device="cpu"), CFG, 2)
    ckpt.save_checkpoint(tmpdir_path, state._asdict(), 2,
                         engine_config=EngineConfig(codec="blosc"),
                         device_compress=True)
    back, _ = ckpt.restore_checkpoint(tmpdir_path, state._asdict())
    a = state_to_numpy(sim.pic_run_chunk(state, CFG, 3))
    b = state_to_numpy(sim.pic_run_chunk(sim.PicState(**back), CFG, 3))
    for k, v in a.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)
    assert ckpt.list_checkpoints(tmpdir_path) == [2]


def test_port_example_writes_a_series_jax_reads(capsys):
    workdir = pic_simulation.main(["--scale", "1024", "--steps", "20",
                                   "--mvstep", "10", "--dmpstep", "10",
                                   "--device", "cpu"])
    try:
        assert "restart from step 20 OK -> continued to 120" in \
            capsys.readouterr().out
        with JBpReader(workdir / "diag.bp4") as r:
            assert r.valid_steps() == [10, 20]
            assert r.attributes(10)["software"] == "repro-jbp"
            rho = r.read_var(20, "/data/20/meshes/density_e")
            assert rho.shape == (100_000 // 1024,) and rho.sum() > 0
            x = r.read_var(20, "/data/20/particles/e/position/x")
            assert x.shape == ((1 << 25) // 1024,)
            assert ((x >= 0) & (x <= 1)).all()
        assert jckpt.list_checkpoints(workdir / "ckpt") == [10, 20]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------- manager
# The manager cases of the JAX package's tests/test_ckpt.py and
# test_shm_transport.py, on the port's CheckpointManager, with a PIC state
# of CPU tensors (the port has no train state yet).

def _pic_state(seed=1):
    return sim.pic_run_chunk(sim.init_sim(CFG, seed, device="cpu"), CFG,
                             1)._asdict()


def _assert_same_state(got, want):
    a, b = ckpt.flatten_state(got), ckpt.flatten_state(want)
    assert list(a) == list(b)
    for k, v in b.items():
        if isinstance(v, torch.Tensor):
            assert a[k].dtype == v.dtype and torch.equal(a[k], v), k
        else:
            assert a[k] == v, k


def test_manager_retention_and_latest(tmpdir_path):
    state = _pic_state()
    mgr = CheckpointManager(tmpdir_path, every=1, keep_n=2, async_write=False,
                            engine_async=True)
    for s in (1, 2, 3, 4):
        state = dict(state, step=torch.tensor(s, dtype=torch.int32))
        mgr.save(state, s)
    assert ckpt.list_checkpoints(tmpdir_path) == [3, 4]
    restored, step = mgr.restore_latest(state)
    assert step == 4 and int(restored["step"]) == 4


def test_manager_skips_corrupt_checkpoint(tmpdir_path):
    state = _pic_state()
    mgr = CheckpointManager(tmpdir_path, every=1, keep_n=5, async_write=False)
    mgr.save(state, 1)
    mgr.save(state, 2)
    idx = ckpt.checkpoint_path(tmpdir_path, 2) / "md.idx"
    idx.write_bytes(b"")
    restored = mgr.restore_latest(state)
    assert restored is not None and restored[1] == 1
    _assert_same_state(restored[0], state)


def test_async_save_overlaps(tmpdir_path):
    state = _pic_state()
    mgr = CheckpointManager(tmpdir_path, every=1, keep_n=3, async_write=True)
    mgr.save(state, 1)
    mgr.save(state, 2)        # waits for 1, then writes 2 in background
    mgr.wait()
    assert ckpt.list_checkpoints(tmpdir_path) == [1, 2]
    assert mgr.stats["saves"] == 2 and mgr.stats["write_s"] > 0
    assert 0.0 <= mgr.overlap_fraction() <= 1.0


def test_manager_persistent_parallel_plane_reuses_worker_pids(tmpdir_path):
    """parallel_io checkpoints keep one WriterPlane alive: two consecutive
    saves run on the SAME worker pids."""
    state = {"w": torch.arange(256, dtype=torch.float32).reshape(16, 16),
             "b": torch.ones(16)}
    with CheckpointManager(tmpdir_path, every=1, keep_n=3,
                           async_write=False, parallel_io=2,
                           n_io_ranks=4) as mgr:
        mgr.save(state, 1)
        mgr.wait()
        plane = mgr._plane
        assert plane is not None and plane.alive()
        pids = plane.pids()
        mgr.save(state, 2)
        mgr.wait()
        assert mgr._plane is plane, "manager respawned the plane"
        assert plane.pids() == pids, "saves did not reuse the worker pids"
        assert all(p.is_alive() for p, _ in plane.workers)
        assert ckpt.list_checkpoints(tmpdir_path) == [1, 2]
        restored, step = mgr.restore_latest(state, parallel=2)
        assert step == 2
        assert torch.equal(restored["w"], state["w"])
    assert not plane.alive()
    for p, _ in plane.workers:
        p.join(timeout=10)
    assert all(not p.is_alive() for p, _ in plane.workers)


def test_checkpoint_manager_survives_killed_plane_worker(tmpdir_path):
    """Kill a plane worker between saves: the manager shuts the dead plane
    down (unlinking its rings) and respawns a fresh one, so the next save
    just succeeds."""
    import os
    import pathlib
    import signal

    state = {"w": torch.arange(256, dtype=torch.float32).reshape(16, 16)}
    with CheckpointManager(tmpdir_path, every=1, parallel_io=2,
                           async_write=False, n_io_ranks=4) as m:
        assert m.save(state, 1)
        m.wait()
        plane = m._plane
        old_names = [r.name for r in plane.rings]
        os.kill(plane.workers[0][0].pid, signal.SIGKILL)
        plane.workers[0][0].join(timeout=10.0)
        assert m.save(state, 2)
        m.wait()
        assert m._plane is not plane
        assert [r.name for r in m._plane.rings] != old_names
        assert not any(pathlib.Path(f"/dev/shm/{n}").exists()
                       for n in old_names), "dead plane leaked its rings"
    restored, step = ckpt.restore_checkpoint(tmpdir_path, dict(state))
    assert step == 2
    assert torch.equal(restored["w"], state["w"])


@pytest.mark.parametrize("device_compress,parallel_io",
                         [(False, 0), (True, 0), (True, 2)])
def test_save_then_change_in_place_restores_the_saved_values(
        tmpdir_path, device_compress, parallel_io):
    """save() returns before the write; the producer then changes every
    tensor in place. The checkpoint holds the values at save()."""
    state = _pic_state()
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in ckpt.flatten_state(state).items()}
    with CheckpointManager(tmpdir_path, every=1, async_write=True,
                           device_compress=device_compress,
                           parallel_io=parallel_io, n_io_ranks=4,
                           engine_config=EngineConfig(codec="blosc")) as m:
        assert m.save(state, 3)
        for v in ckpt.flatten_state(state).values():
            if isinstance(v, torch.Tensor):
                v.logical_not_() if v.dtype == torch.bool else v.fill_(77)
        m.wait()
        back, step = m.restore_latest(state)
    assert step == 3
    _assert_same_state(back, ckpt.unflatten_like(state, want))


def test_manager_device_compress_counts_the_shuffled_bytes(tmpdir_path):
    """A device-compressed parallel save shuffles the same leaves as the
    serial one (72 C + 8 bytes of a PIC state) and restores bit for bit."""
    state = _pic_state()
    with CheckpointManager(tmpdir_path, every=1, async_write=True,
                           device_compress=True, parallel_io=2,
                           n_io_ranks=4,
                           engine_config=EngineConfig(codec="blosc")) as m:
        m.save(state, 5)
        m.wait()
        assert MONITOR.report()["total"][CTR.COMPRESS_DEVICE_BYTES] == \
            72 * CFG.capacity + 8
        back, step = m.restore_latest(state)
    assert step == 5
    _assert_same_state(back, state)


def test_restore_latest_onto_a_mesh_raises(tmpdir_path):
    state = _pic_state()
    m = CheckpointManager(tmpdir_path, every=1, async_write=False)
    m.save(state, 1)
    with pytest.raises(NotImplementedError, match="mesh"):
        m.restore_latest(state, shardings={})
    assert m.restore_latest(state)[1] == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_of_either_manager_restores_in_the_other(tmpdir_path,
                                                            writer):
    """A checkpoint written by one package's CheckpointManager (through
    its parallel write plane) is restored by the other's."""
    from repro.ckpt.manager import CheckpointManager as JCheckpointManager
    jstate, flat = _jax_state()
    tstate = state_from_numpy(flat, "cpu")._asdict()
    jlike = jax.tree_util.tree_map(np.asarray, jstate._asdict())
    if writer == "jax":
        with JCheckpointManager(tmpdir_path, every=1, async_write=False,
                                parallel_io=2, n_io_ranks=4,
                                engine_config=JEngineConfig(
                                    codec="blosc")) as m:
            m.save(jstate._asdict(), 4)
        back, step = CheckpointManager(tmpdir_path).restore_latest(
            sim.init_sim(CFG, 9, device="cpu")._asdict())
        assert step == 4
        _assert_same_state(back, tstate)
    else:
        with CheckpointManager(tmpdir_path, every=1, async_write=False,
                               parallel_io=2, n_io_ranks=4,
                               device_compress=True,
                               engine_config=EngineConfig(
                                   codec="blosc")) as m:
            m.save(tstate, 4)
        back, step = JCheckpointManager(tmpdir_path).restore_latest(jlike)
        assert step == 4
        got = {k: np.asarray(v)
               for k, v in jckpt.flatten_state(back).items()}
        assert sorted(got) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# ------------------------------------------------------ model and train state
def _model_pair(arch):
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduce_for_smoke as jreduce
    from repro.models import model as JM
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.models.convert import params_from_numpy
    jcfg, cfg = jreduce(jget(arch)), reduce_for_smoke(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, cfg, jp, tp


def _assert_tree_equals_jax(port_tree, jax_tree):
    """Each of the port's leaves (a group of layers stacked) equals the
    JAX package's leaf of the same name: dtype, shape and bits."""
    want = {k: np.asarray(v) for k, v in jckpt.flatten_state(jax_tree).items()}
    got = ckpt.flatten_state(port_tree)
    assert list(got) == list(want)
    for name, leaf in got.items():
        parts = leaf.parts if isinstance(leaf, ckpt.Stacked) else [leaf]
        t = torch.stack([p.detach() for p in parts]).reshape(
            want[name].shape) if isinstance(leaf, ckpt.Stacked) else leaf
        if t.dtype == torch.bfloat16:
            t = t.float()
            w = want[name].astype(np.float32)
        else:
            w = want[name]
        assert tuple(t.shape) == w.shape, name
        assert str(t.numpy().dtype) == str(w.dtype), name
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b",
                                  "deepseek-moe-16b",
                                  "llama-3.2-vision-90b"])
def test_model_variable_names_and_shapes_match_jax(arch):
    """flatten_state of the port's params gives the JAX package's names;
    each group of layers is one `Stacked` leaf of the stacked shape."""
    jcfg, cfg, jp, tp = _model_pair(arch)
    jflat = jckpt.flatten_state({"params": jp})
    tflat = ckpt.flatten_state({"params": tp})
    assert list(tflat) == list(jflat)
    for name, leaf in tflat.items():
        assert tuple(leaf.shape) == tuple(jflat[name].shape), name
    back = ckpt.unflatten_like({"params": tp}, tflat)
    assert back["params"]["stack"] is not tp["stack"]
    for a, b in zip(ckpt.flatten_state(back).values(), tflat.values()):
        pa = a.parts if isinstance(a, ckpt.Stacked) else [a]
        pb = b.parts if isinstance(b, ckpt.Stacked) else [b]
        assert all(x is y for x, y in zip(pa, pb))


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b",
                                  "deepseek-moe-16b",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("device_compress", [False, True])
def test_model_checkpoint_crosses_the_packages(tmpdir_path, arch,
                                               device_compress):
    """The port's params restore in the JAX package bit for bit (and the
    port's own restore too), with the host path (stacked on the host and
    row-split as the JAX package splits it) and with the device codec
    path (each layer a chunk of the stacked variable); the JAX package's
    params restore in the port's lists."""
    jcfg, cfg, jp, tp = _model_pair(arch)
    from repro_torch.models import model as M
    ckpt.save_checkpoint(tmpdir_path / "port", {"params": tp}, 5,
                         n_io_ranks=4,
                         engine_config=EngineConfig(codec="blosc"),
                         device_compress=device_compress)
    jlike = jax.tree_util.tree_map(np.asarray, {"params": jp})
    back, step = jckpt.restore_checkpoint(tmpdir_path / "port", jlike)
    assert step == 5
    _assert_tree_equals_jax({"params": tp}, back)
    like = {"params": M.init_params(cfg, 7, device="cpu")}
    mine, _ = ckpt.restore_checkpoint(tmpdir_path / "port", like)
    _assert_tree_equals_jax(mine, {"params": jp})
    jckpt.save_checkpoint(tmpdir_path / "jax", {"params": jp}, 6,
                          n_io_ranks=4,
                          engine_config=JEngineConfig(codec="blosc"))
    theirs, step = ckpt.restore_checkpoint(tmpdir_path / "jax", like)
    assert step == 6
    _assert_tree_equals_jax(theirs, {"params": jp})


def test_stacked_host_chunks_are_the_jax_packages(tmpdir_path):
    """On the host path a stacked variable's chunk table is the JAX
    package's: the same offsets, ranks and extents."""
    from repro.core.bp_engine import BpReader as JReader
    _, _, jp, tp = _model_pair("zamba2-2.7b")
    ckpt.save_checkpoint(tmpdir_path / "p", {"params": tp}, 1, n_io_ranks=4)
    jckpt.save_checkpoint(tmpdir_path / "j", {"params": jp}, 1, n_io_ranks=4)
    name = "state/params/stack/units/mamba/wx/w"
    tables = []
    for d in ("p", "j"):
        with JReader(ckpt.checkpoint_path(tmpdir_path / d, 1)) as r:
            tables.append([(c.offset, c.extent, c.rank)
                           for c in r.iter_chunks(1, name)])
    assert tables[0] == tables[1] and len(tables[0]) == 2


@pytest.fixture(scope="module")
def jax_trainer_ckpt():
    """A JAX package's Trainer run to step 2 (checkpoints every 2) and
    its continuation to step 3 in a copy of the directory, so the
    port can resume from the step-2 checkpoint."""
    import pathlib
    import tempfile
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduce_for_smoke as jreduce
    from repro.optim.adamw import AdamWConfig as JHP
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTC
    root = pathlib.Path(tempfile.mkdtemp(prefix="repro-torch-jtrainer-"))
    jcfg = jreduce(jget("smollm-360m"))
    hp = JHP(lr=1e-3, warmup_steps=1, total_steps=3)
    tc = dict(log_every=1, ckpt_every=2, seq_len=32, global_batch=4)
    JTrainer(jcfg, JTC(steps=2, **tc), hp, root / "a").run()
    shutil.copytree(root / "a", root / "b")
    cont = JTrainer(jcfg, JTC(steps=3, **tc), hp, root / "b").run()
    yield {"dir": root / "a", "tc": tc, "cont": cont, "jcfg": jcfg}
    shutil.rmtree(root, ignore_errors=True)


def test_jax_trainer_checkpoint_resumes_in_the_port_trainer(
        jax_trainer_ckpt, tmpdir_path):
    """The port's Trainer resumes from the JAX Trainer's step-2 checkpoint
    (params, m, v and step under the JAX names) and its step-3 loss
    matches the JAX continuation's within 1e-3 (the loss_fn tolerance:
    bf16 rounding and XLA's sum orders)."""
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    d = tmpdir_path / "ck"
    shutil.copytree(jax_trainer_ckpt["dir"], d)
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    tr = Trainer(cfg, TrainerConfig(steps=3, **jax_trainer_ckpt["tc"]),
                 AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3), d,
                 device="cpu", async_write=False)
    out = tr.run()
    assert [h["step"] for h in out["history"]] == [3]
    want = jax_trainer_ckpt["cont"]["history"][-1]
    assert want["step"] == 3
    assert abs(out["history"][0]["loss"] - want["loss"]) < 1e-3
    np.testing.assert_allclose(out["history"][0]["lr"], want["lr"],
                               rtol=1e-6)
    assert int(out["state"]["step"]) == 3


def test_port_trainer_checkpoint_restores_in_the_jax_manager(tmpdir_path):
    """A port Trainer's checkpoint restores in the JAX package's
    CheckpointManager with arrays equal to the port's state."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduce_for_smoke as jreduce
    from repro.ckpt.manager import CheckpointManager as JCheckpointManager
    from repro.train.state import init_train_state as jinit
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = reduce_for_smoke(get_config("zamba2-2.7b"))
    out = Trainer(cfg, TrainerConfig(steps=2, ckpt_every=2, seq_len=32,
                                     global_batch=2, log_every=1),
                  AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
                  tmpdir_path, device="cpu", device_compress=True).run()
    jlike = jax.tree_util.tree_map(
        np.asarray, jinit(jreduce(jget("zamba2-2.7b")),
                          jax.random.PRNGKey(1)))
    back, step = JCheckpointManager(tmpdir_path).restore_latest(jlike)
    assert step == 2
    assert int(np.asarray(back["step"])) == 2
    _assert_tree_equals_jax(out["state"], back)


def test_serve_launcher_serves_a_jax_trainer_checkpoint(jax_trainer_ckpt,
                                                        capsys):
    """`repro_torch.launch.serve --ckpt-dir` on the JAX Trainer's
    checkpoint: it restores the params and generates the tokens the port's
    engine gives for the JAX package's params of that step."""
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.launch import serve
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro.models import model as JM
    d = jax_trainer_ckpt["dir"]
    toks = serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                       "--ckpt-dir", str(d), "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "4",
                       "--max-seq", "16"])
    assert "restored checkpoint step 2" in capsys.readouterr().out
    like = {"params": jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax_trainer_ckpt["jcfg"],
                                   jax.random.PRNGKey(3)))}
    jparams, step = jckpt.restore_checkpoint(d, like)
    assert step == 2
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    eng = ServeEngine(cfg, params_from_numpy(cfg, jparams["params"],
                                             device="cpu"),
                      ServeConfig(max_batch=2, max_seq=16, max_new_tokens=4))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    np.testing.assert_array_equal(toks, eng.generate(prompts, new_tokens=4))
