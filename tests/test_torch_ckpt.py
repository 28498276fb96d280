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
from repro_torch.core.bp_engine import BpReader
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


#: a codec block smaller than a row chunk of the test state's particle
#: leaves at 4 I/O ranks (1 KiB and 3 KiB), so each chunk holds several
SPLIT_BLOCK = 512


@pytest.mark.parametrize("device_compress,async_io,block", [
    pytest.param(False, False, None, id="False-False"),
    pytest.param(True, False, None, id="True-False"),
    pytest.param(True, True, None, id="True-True"),
    pytest.param(True, False, SPLIT_BLOCK, id="True-False-split"),
    pytest.param(True, True, SPLIT_BLOCK, id="True-True-split")])
def test_port_checkpoint_restores_in_jax(tmpdir_path, device_compress,
                                         async_io, block):
    jstate, flat = _jax_state()
    tstate = sim.pic_run_chunk(state_from_numpy(flat, "cpu"), CFG, 2)
    engine = EngineConfig(codec="blosc", **(
        {"compression_block": block} if block else {}))
    ckpt.save_checkpoint(tmpdir_path, tstate._asdict(), 2, n_io_ranks=4,
                         engine_config=engine,
                         device_compress=device_compress, async_io=async_io)
    with BpReader(ckpt.checkpoint_path(tmpdir_path, 2)) as r:
        assert len(list(r.iter_chunks(2, "state/electrons/.x"))) == 4
        assert len(list(r.iter_chunks(2, "state/key"))) == 2
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


def test_device_leaf_is_row_split_as_a_host_leaf():
    """A device leaf is row-split by rank with the host path's bounds,
    however small, its chunks views of its rows: a leaf of many rows, one
    of fewer rows than ranks (the key) and one of rank 2."""
    leaves = [torch.arange(511, dtype=torch.float32),
              torch.tensor([7, 9], dtype=torch.int32),
              torch.arange(30, dtype=torch.float32).reshape(10, 3)]
    for leaf in leaves:
        got = list(ckpt._chunks(leaf, True, 4))
        want = list(ckpt._chunks(leaf, False, 4))
        assert [c[:3] for c in got] == [c[:3] for c in want]
        assert len(got) == min(4, leaf.shape[0])
        for (_, _, _, c), (_, _, _, h) in zip(got, want):
            assert isinstance(c, torch.Tensor)
            assert c.untyped_storage().data_ptr() == \
                leaf.untyped_storage().data_ptr()
            np.testing.assert_array_equal(c.numpy(), h)
    assert [c[:3] for c in ckpt._chunks(leaves[0], True, 4)] == \
        [((511,), (lo,), r) for r, lo in enumerate((0, 127, 255, 383))]


def _chunk_table(path, step: int) -> dict:
    """Each variable's chunks as ((rank, offset, extent, aggregator),
    (min, max), payload bytes), in table order."""
    out = {}
    with BpReader(path) as r:
        for name in r.var_names(step):
            out[name] = []
            for c in r.iter_chunks(step, name):
                with open(path / f"data.{c.agg}", "rb") as f:
                    f.seek(c.file_offset)
                    payload = f.read(c.nbytes)
                out[name].append(((c.rank, c.offset, c.extent, c.agg),
                                  (c.vmin, c.vmax), payload))
    return out


def test_device_compressed_save_matches_the_host_path(tmpdir_path):
    """A device-compressed checkpoint has the host path's chunk table
    (rank, offset, extent, aggregator) and the same min/max (the device
    reduction ignores NaNs as the host's does; this state has none). Each
    chunk's payload is the host path's, and the subfiles are the host
    path's byte for byte, outside the key's two chunks. The key's chunks
    (one uint32 each) do not compress and are stored raw, and a raw block
    that the device shuffled keeps FLAG_PRESHUFFLED (the codec's rule, so
    its decode knows the layout); the host path's raw block has no flag.
    The blocks here (2 KiB, a chunk of x 4 KiB) are large enough that every
    particle block compresses."""
    from repro_torch.core import compression as C
    cfg = jsim.PicConfig(n_cells=64, capacity=4096, n_electrons=2048,
                         n_ions=2048, n_neutrals=2048, rate_R=0.5, dt=1e-2)
    state = sim.pic_run_chunk(sim.init_sim(cfg, 3, device="cpu"), cfg,
                              2)._asdict()
    engine = EngineConfig(codec="blosc", aggregators=2,
                          compression_block=2048)
    paths = {}
    for dev in (True, False):
        paths[dev] = ckpt.save_checkpoint(
            tmpdir_path / str(dev), state, 2, n_io_ranks=4,
            engine_config=engine, device_compress=dev)
    dev, host = (_chunk_table(paths[d], 2) for d in (True, False))
    assert sorted(dev) == sorted(host)
    for name in dev:
        assert [c[:2] for c in dev[name]] == [c[:2] for c in host[name]], \
            name
        if name != "state/key":
            assert [c[2] for c in dev[name]] == [c[2] for c in host[name]], \
                name
    assert sum(len(dev[n]) == 4 for n in dev) == 12   # x, v, w, alive x 3
    assert [c[0] for c in dev["state/key"]] == [(0, (0,), (1,), 0),
                                                (1, (1,), (1,), 0)]
    for (*_, d), (*_, h) in zip(dev["state/key"], host["state/key"]):
        ((_, dc, _, df, _, _),) = C.iter_block_headers(d)
        ((_, hc, _, hf, _, _),) = C.iter_block_headers(h)
        assert C.CODEC_NAMES[dc] == C.CODEC_NAMES[hc] == "none"
        assert df & C.FLAG_PRESHUFFLED and not hf & C.FLAG_PRESHUFFLED
        assert C.decompress(d) == C.decompress(h)
    for agg in range(2):
        kept = []
        for d in (True, False):
            with BpReader(paths[d]) as r:
                skip = sorted((c.file_offset, c.nbytes)
                              for c in r.iter_chunks(2, "state/key")
                              if c.agg == agg)
            data = (paths[d] / f"data.{agg}").read_bytes()
            for off, n in reversed(skip):
                data = data[:off] + data[off + n:]
            kept.append(data)
        assert kept[0] == kept[1], f"data.{agg}"


def test_split_save_books_device_bytes_on_every_subfile(tmpdir_path):
    """The split engages: each of the four aggregators' subfiles books a
    quarter of the particle leaves' device-shuffled bytes (data.0 and
    data.1 a row of the key besides), and they sum to 72 B a slot + 8."""
    state = _pic_state()
    ckpt.save_checkpoint(
        tmpdir_path, state, 1, n_io_ranks=4,
        engine_config=EngineConfig(codec="blosc", aggregators=4, workers=4),
        device_compress=True)
    rep = MONITOR.report()
    booked = {int(p.rsplit(".", 1)[1]): c.get(CTR.COMPRESS_DEVICE_BYTES, 0)
              for p, c in rep["files"].items()
              if p.rsplit("/", 1)[-1].startswith("data.")}
    quarter = 3 * 24 * CFG.capacity // 4
    assert booked == {0: quarter + 4, 1: quarter + 4, 2: quarter,
                      3: quarter}
    assert rep["total"][CTR.COMPRESS_DEVICE_BYTES] == \
        3 * 24 * CFG.capacity + 8
    back, _ = ckpt.restore_checkpoint(tmpdir_path, state)
    _assert_same_state(back, state)


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
    """Shardings that miss the state's leaves make `restore_sharded` raise,
    so the manager finds no checkpoint that restores onto the mesh and
    returns None; shardings on a one-device mesh restore DTensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import replicated
    state = _pic_state()
    m = CheckpointManager(tmpdir_path, every=1, async_write=False)
    m.save(state, 1)
    with pytest.raises(KeyError):
        ckpt.restore_sharded(tmpdir_path, state, {})
    assert m.restore_latest(state, shardings={}) is None
    mesh = make_mesh((1,), ("data",), device_type="cpu")
    try:
        flat = ckpt.flatten_state(state)
        sh = ckpt.unflatten_like(state, {k: replicated(mesh) for k in flat})
        back, step = m.restore_latest(state, shardings=sh)
    finally:
        dist.destroy_process_group()
    assert step == 1
    got = ckpt.flatten_state(back)
    assert all(isinstance(got[k], DTensor) for k, v in flat.items()
               if isinstance(v, torch.Tensor))
    _assert_same_state(ckpt.unflatten_like(state, {
        k: v.to_local() if isinstance(v, DTensor) else v
        for k, v in got.items()}), state)
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
