"""Sharded checkpoints and elastic restore, the counterpart of the JAX
package's `test_elastic_resharding_subprocess`: DTensor states saved by 4
gloo ranks on a (2, 2) mesh (one module-scoped `RankPool`, a `FileStore`
in a temp dir) and restored on (4, 1) and whole. The port's sharded
chunk table is the JAX package's for the same layout (the files are
byte-identical on the host path, `md.idx` aside from `t_ns`), and each
package restores the other's sharded checkpoint; the JAX side runs in a
subprocess with 4 host devices. The save with one writer a rank
(`parallel_io=W`) writes the files of the JAX package's
`save_checkpoint(parallel_io=W)` of the same state, and no rank's shard
bytes reach rank 0 (each rank's Darshan bytes written are its own
chunks). No JAX in this process: the rank processes import this
module."""
import json
import math
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.core.bp_engine import BpReader, EngineConfig
from repro_torch.core.darshan import MONITOR
from repro_torch.data.pipeline import SyntheticTokens, to_device
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as S
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.train.state import (init_train_state, train_state_shapes,
                                     train_state_shardings)
from repro_torch.train.step import make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
IDX = struct.Struct("<QQQIIQQQ")     # md.idx record; field 5 is t_ns
CFG = reduce_for_smoke(get_config("smollm-360m"))


def _small_state() -> dict:
    """8x8 f32 over both axes, 4x8 bf16 over `model` (replicas over
    `data`), a 0-d int32 step."""
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.arange(32, dtype=torch.float32).reshape(4, 8)
                      .to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}


SMALL_SPECS = {"w": ("data", "model"), "b": (None, "model"), "step": ()}
#: the (4, 1) layout of the restores
RESTORE_SPECS = {"w": ("model", "data"), "b": (None, "data"), "step": ()}


def _shard(state, shardings):
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements),
                    state, shardings)


def _named(mesh, specs) -> dict:
    return {k: S.NamedSharding(mesh, S.P(*v)) for k, v in specs.items()}


def _like(state):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)


def _report(state) -> dict:
    """Each DTensor leaf of this rank: its box offset and local values (as
    float64, bf16 included), and its placements."""
    out = {}
    for name, leaf in ckpt.flatten_state(state).items():
        parts = leaf.parts if isinstance(leaf, ckpt.Stacked) else [leaf]
        out[name] = [(list(ckpt._local_box(p)) if p.ndim else [],
                      p.to_local().double().numpy(),
                      [str(q) for q in p.placements]) for p in parts]
    return out


# ------------------------------------------------------------- rank tasks
def _rank_save_small(directory, step, parallel_io=0):
    mesh = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    state = _shard(_small_state(), _named(mesh, SMALL_SPECS))
    MONITOR.reset()
    path = ckpt.save_checkpoint(directory, state, step, n_io_ranks=4,
                                parallel_io=parallel_io)
    if not parallel_io:
        return str(path)
    return str(path), dict(ckpt.SAVE_STATS), _data_bytes_written()


def _data_bytes_written() -> dict:
    """This process's Darshan bytes written, by `data.<w>` subfile it wrote
    to (rank 0 also creates them all, empty)."""
    per_file = MONITOR.snapshot()["per_file"]
    return {pathlib.Path(p).name: c["POSIX_BYTES_WRITTEN"]
            for p, c in per_file.items()
            if pathlib.Path(p).name.startswith("data.")
            and c.get("POSIX_BYTES_WRITTEN", 0.0) > 0}


def _rank_restore_small(directory):
    mesh = tmesh.make_mesh((4, 1), AXES, device_type="cpu")
    out, step = ckpt.restore_sharded(directory, _like(_small_state()),
                                     _named(mesh, RESTORE_SPECS))
    return dist.get_rank(), step, _report(out)


def _rank_save_small_failing(directory, step, bad_rank):
    """The small state saved one writer a rank with rank `bad_rank`
    failing to encode its chunks: the error every rank raised."""
    mesh = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    state = _shard(_small_state(), _named(mesh, SMALL_SPECS))
    real = ckpt.C.outbound_chunk

    def broken(chunk, cfg, path=None, codec=None):
        raise OSError("disk full")
    if dist.get_rank() == bad_rank:
        ckpt.C.outbound_chunk = broken
    try:
        ckpt.save_checkpoint(directory, state, step, n_io_ranks=4,
                             parallel_io=4)
    except RuntimeError as e:
        return str(e)
    finally:
        ckpt.C.outbound_chunk = real
    return "saved"


def _rank_latest_small(directory):
    mesh = tmesh.make_mesh((4, 1), AXES, device_type="cpu")
    got = CheckpointManager(directory).restore_latest(
        _like(_small_state()), shardings=_named(mesh, RESTORE_SPECS))
    return got[1], _report(got[0])


def _rank_train_state(directory, device_compress, parallel_io=0):
    """The smoke smollm train state on (2, 2), saved, then restored on
    (4, 1); returns the restored boxes (and with `parallel_io` the
    save's numbers)."""
    state = init_train_state(CFG, 0, device="cpu")
    m22 = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    sharded = _shard(state, train_state_shardings(CFG, m22))
    MONITOR.reset()
    ckpt.save_checkpoint(directory, sharded, 5, n_io_ranks=4,
                         engine_config=EngineConfig(codec="blosc"),
                         device_compress=device_compress,
                         parallel_io=parallel_io)
    stats = (dict(ckpt.SAVE_STATS), _data_bytes_written())
    m41 = tmesh.make_mesh((4, 1), AXES, device_type="cpu")
    out, step = ckpt.restore_sharded(directory, train_state_shapes(CFG),
                                     train_state_shardings(CFG, m41))
    if parallel_io:
        return step, _report(out), stats
    return step, _report(out)


def _rank_step_on_a_mesh(shape, axes):
    """One step of the smoke state on a mesh of `axes`: its loss, or the
    error it raises."""
    from torch.distributed.device_mesh import init_device_mesh
    state = init_train_state(CFG, 0, device="cpu")
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    shardings = train_state_shardings(CFG, mesh)
    sharded = _shard(state, shardings)
    batch = to_device(SyntheticTokens(CFG.padded_vocab, 16, 4, seed=0)
                      .batch_at(0), "cpu")
    try:
        _, m = make_train_step(CFG, AdamWConfig(), q_chunk=16, kv_chunk=16)(
            sharded, batch)
    except ValueError as e:
        return str(e)
    return float(m["loss"])


# ------------------------------------------------------------------ tests
@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with D.RankPool(4, tmp_path_factory.mktemp("store"), timeout=180) as p:
        yield p


_JAX_SIDE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.ckpt.checkpoint import save_checkpoint, restore_sharded
port_dir, jax_dir, specs, rspecs, parallel_io = json.loads(sys.argv[1])
devs = np.array(jax.devices())
m22 = Mesh(devs.reshape(2, 2), ("data", "model"))
m41 = Mesh(devs.reshape(4, 1), ("data", "model"))
full = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
        "b": np.asarray(jnp.arange(32, dtype=jnp.float32).reshape(4, 8)
                        .astype(jnp.bfloat16)),
        "step": np.int32(7)}
state = {k: jax.device_put(v, NamedSharding(m22, P(*specs[k])))
         for k, v in full.items()}
save_checkpoint(jax_dir, state, 3, n_io_ranks=4, parallel_io=parallel_io)
like = {k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
        for k, v in full.items()}
out, step = restore_sharded(port_dir, like,
                            {k: NamedSharding(m41, P(*rspecs[k]))
                             for k in full})
ok = step == 3 and all(
    np.array_equal(np.asarray(out[k]).astype(np.float64),
                   np.asarray(full[k]).astype(np.float64)) for k in full)
print(json.dumps({"ok": bool(ok), "step": int(step)}))
"""


def _jax_side(port_dir, jax_dir, parallel_io=0) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    arg = json.dumps([str(port_dir), str(jax_dir), SMALL_SPECS,
                      RESTORE_SPECS, parallel_io])
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, arg], env=env,
                       capture_output=True, text=True, timeout=180,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _chunk_table(path, step) -> dict:
    with BpReader(path) as r:
        return {v: (r.var_info(step, v)["shape"],
                    [(c.offset, c.extent, c.rank, c.agg, c.nbytes)
                     for c in r.iter_chunks(step, v)])
                for v in r.var_names(step)}


def _idx_records(path) -> list:
    raw = (path / "md.idx").read_bytes()
    return [IDX.unpack_from(raw, o) for o in range(0, len(raw), IDX.size)]


def _check_restored(results, full: dict):
    """Each rank's boxes hold the global arrays' values there."""
    for _rank, step, rep in results:
        assert step == 3
        for name, [(off, vals, _pl)] in rep.items():
            want = full[name].double().numpy()
            sl = tuple(slice(o, o + e) for o, e in zip(off, vals.shape))
            np.testing.assert_array_equal(vals, want[sl] if sl else want,
                                          err_msg=name)


def test_sharded_save_is_the_jax_packages_and_each_restores_the_other(
        pool, tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    paths = pool.run(_rank_save_small, str(port_dir), 3)
    assert paths == [str(ckpt.checkpoint_path(port_dir, 3))] * 4
    res = _jax_side(port_dir, jax_dir)
    assert res["ok"] and res["step"] == 3
    # the chunk table: one chunk a device, replicas and the 0-d step too
    tp, tj = (ckpt.checkpoint_path(d, 3) for d in (port_dir, jax_dir))
    table = _chunk_table(tp, 3)
    assert table == _chunk_table(tj, 3)
    assert [c[:3] for c in table["state/w"][1]] == [
        ((0, 0), (4, 4), 0), ((0, 4), (4, 4), 1),
        ((4, 0), (4, 4), 2), ((4, 4), (4, 4), 3)]
    assert [c[:3] for c in table["state/b"][1]] == [
        ((0, 0), (4, 4), 0), ((0, 4), (4, 4), 1),
        ((0, 0), (4, 4), 2), ((0, 4), (4, 4), 3)]
    assert table["state/step"][0] == []
    assert [c[:3] for c in table["state/step"][1]] == [
        ((), (1,), r) for r in range(4)]
    # byte-identical data and metadata, md.idx aside from its t_ns field
    names = sorted(p.name for p in tp.iterdir())
    assert names == sorted(p.name for p in tj.iterdir())
    assert "data.0" in names and "md.0" in names
    for name in names:
        if name.startswith("data.") or name == "md.0":
            assert (tp / name).read_bytes() == (tj / name).read_bytes(), name
    for a, b in zip(_idx_records(tp), _idx_records(tj)):
        assert a[:5] + a[6:] == b[:5] + b[6:]
    # the port restores JAX's checkpoint elastically, (2, 2) -> (4, 1)
    full = _small_state()
    results = pool.run(_rank_restore_small, str(jax_dir))
    _check_restored(results, full)
    boxes = sorted(rep["w"][0][0] for _r, _s, rep in results)
    assert boxes == [[0, 0], [0, 2], [0, 4], [0, 6]]
    assert all(rep["w"][0][2] == ["S(1)", "S(0)"]
               for _r, _s, rep in results)
    # and its own, whole
    back, step = ckpt.restore_checkpoint(port_dir, _small_state())
    assert step == 3
    for k, v in full.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("device_compress", [False, True])
def test_train_state_restores_bit_exact_on_4x1_and_whole(pool, tmp_path,
                                                         device_compress):
    results = pool.run(_rank_train_state, str(tmp_path), device_compress)
    want = ckpt.flatten_state(init_train_state(CFG, 0, device="cpu"))
    n_leaves = 0
    for step, rep in results:
        assert step == 5
        for name, parts in rep.items():
            leaf = want[name]
            full = leaf.parts if isinstance(leaf, ckpt.Stacked) else [leaf]
            assert len(parts) == len(full), name
            for (off, vals, _pl), t in zip(parts, full):
                sl = tuple(slice(o, o + e) for o, e in zip(off, vals.shape))
                np.testing.assert_array_equal(
                    vals, t.double().numpy()[sl] if sl else t.numpy(),
                    err_msg=name)
                n_leaves += 1
    assert n_leaves == 4 * sum(len(v.parts) if isinstance(v, ckpt.Stacked)
                               else 1 for v in want.values())
    # whole, in one process, bit for bit
    back, step = ckpt.restore_checkpoint(
        tmp_path, init_train_state(CFG, 1, device="cpu"))
    got = ckpt.flatten_state(back)
    for name, leaf in want.items():
        a = leaf.parts if isinstance(leaf, ckpt.Stacked) else [leaf]
        b = got[name].parts if isinstance(leaf, ckpt.Stacked) else [
            got[name]]
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    # one chunk a rank's shard, replicas included; with device_compress one
    # a rank and layer of a stacked variable
    table = _chunk_table(ckpt.checkpoint_path(tmp_path, 5), 5)
    layers = CFG.n_layers
    for var, (_shape, chunks) in table.items():
        stacked = "/layers/" in var
        n = 4 * (layers if stacked and device_compress else 1)
        assert len(chunks) == n, var
        assert sorted({c[2] for c in chunks}) == [0, 1, 2, 3], var


def _files(path) -> dict:
    return {p.name: p.read_bytes() for p in path.iterdir()}


def _rank_bytes(table, world=4, m=4) -> dict:
    """{data.<w>: {rank: payload bytes}} of a chunk table."""
    out: dict = {}
    for _shape, chunks in table.values():
        for _off, _ext, rank, agg, nbytes in chunks:
            out.setdefault(f"data.{agg}", {}).setdefault(rank, 0)
            out[f"data.{agg}"][rank] += nbytes
    return out


@pytest.mark.parametrize("writers", [4, 2])
def test_save_one_writer_a_rank_is_the_jax_planes_and_each_restores_the_other(
        pool, tmp_path, writers):
    """`parallel_io=W`: W = 4 is a writer a rank, W = 2 two ranks a
    subfile. The files are the JAX package's parallel save of the same
    state (its W writer processes), byte for byte: data.<w>, md.0 and
    each md.<w>.shard, md.idx aside from its t_ns; each rank's Darshan
    bytes written are exactly its own chunks, in its writer's subfile."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    results = pool.run(_rank_save_small, str(port_dir), 3, writers)
    assert [r[0] for r in results] == [str(ckpt.checkpoint_path(port_dir,
                                                                3))] * 4
    res = _jax_side(port_dir, jax_dir, parallel_io=writers)
    assert res["ok"] and res["step"] == 3     # JAX restores the port's
    tp, tj = (ckpt.checkpoint_path(d, 3) for d in (port_dir, jax_dir))
    fp, fj = _files(tp), _files(tj)
    assert sorted(fp) == sorted(fj)
    assert sorted(n for n in fp if n.startswith("data.")) == [
        f"data.{w}" for w in range(writers)]
    for name in fp:
        if name.startswith("data.") or name.startswith("md.") and \
                name != "md.idx":
            assert fp[name] == fj[name], name
    for a, b in zip(_idx_records(tp), _idx_records(tj)):
        assert a[:5] + a[6:] == b[:5] + b[6:]
    table = _chunk_table(tp, 3)
    assert table == _chunk_table(tj, 3)
    want = _rank_bytes(table)
    for rank, (_path, stats, wrote) in enumerate(results):
        sub = f"data.{rank * writers // 4}"
        assert stats["path"] == "by_rank" and stats["rank"] == rank
        assert wrote == {sub: float(want[sub][rank])}, rank
        assert stats["bytes_written"] == want[sub][rank]
    assert results[0][1]["bytes_to_rank0"] > 0         # the chunk tables
    # the port restores JAX's parallel save elastically, (2, 2) -> (4, 1)
    _check_restored(pool.run(_rank_restore_small, str(jax_dir)),
                    _small_state())


def test_save_one_writer_a_rank_commits_nothing_when_a_rank_fails(pool,
                                                                  tmp_path):
    """A rank that fails before the commit makes every rank raise (its
    error comes home to each), and no step is published: an earlier
    checkpoint stays the newest, as after a torn step of the plane."""
    pool.run(_rank_save_small, str(tmp_path), 1, 4)
    msgs = pool.run(_rank_save_small_failing, str(tmp_path), 2, 2)
    for m in msgs:
        assert "rank(s) 2" in m and "disk full" in m
    assert ckpt.list_checkpoints(tmp_path) == [1]
    assert not ckpt.checkpoint_path(tmp_path, 2).exists()
    assert (tmp_path / "latest.txt").read_text() == "1"


def test_train_state_saved_one_writer_a_rank_restores_on_4x1(pool,
                                                             tmp_path):
    """The smoke train state through `parallel_io=4`: rank 0 receives
    the chunk tables, a small fraction of what the other ranks write,
    and none of their bytes; restored bit-exact on (4, 1) and whole."""
    results = pool.run(_rank_train_state, str(tmp_path), False, 4)
    want = ckpt.flatten_state(init_train_state(CFG, 0, device="cpu"))
    for step, rep, _stats in results:
        assert step == 5
        for name, parts in rep.items():
            leaf = want[name]
            full = leaf.parts if isinstance(leaf, ckpt.Stacked) else [leaf]
            for (off, vals, _pl), t in zip(parts, full):
                sl = tuple(slice(o, o + e) for o, e in zip(off, vals.shape))
                np.testing.assert_array_equal(
                    vals, t.double().numpy()[sl] if sl else t.numpy(),
                    err_msg=name)
    table = _chunk_table(ckpt.checkpoint_path(tmp_path, 5), 5)
    by = _rank_bytes(table)
    others = 0
    for rank, (_s, _r, (stats, wrote)) in enumerate(results):
        assert wrote == {f"data.{rank}": float(by[f"data.{rank}"][rank])}
        assert set(by[f"data.{rank}"]) == {rank}
        others += stats["bytes_written"] if rank else 0
    received = results[0][2][0]["bytes_to_rank0"]
    assert 0 < received < 0.05 * others
    back, step = ckpt.restore_checkpoint(
        tmp_path, init_train_state(CFG, 1, device="cpu"))
    got = ckpt.flatten_state(back)
    for name, leaf in want.items():
        a = leaf.parts if isinstance(leaf, ckpt.Stacked) else [leaf]
        b = got[name].parts if isinstance(leaf, ckpt.Stacked) else [
            got[name]]
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name


def test_restore_latest_onto_a_mesh_skips_a_corrupt_newest_step(pool,
                                                               tmp_path):
    for step in (1, 2):
        pool.run(_rank_save_small, str(tmp_path), step)
    assert ckpt.list_checkpoints(tmp_path) == [1, 2]
    data = ckpt.checkpoint_path(tmp_path, 2) / "data.0"
    data.write_bytes(data.read_bytes()[:16])
    for step, rep in pool.run(_rank_latest_small, str(tmp_path)):
        assert step == 1
        _check_restored([(0, 3, rep)], _small_state())


def test_train_step_raises_on_a_multi_device_mesh(pool):
    """A step over a (2, 2) mesh of the reference's axes now runs; one over
    a mesh with an axis the model has no hints for raises."""
    losses = pool.run(_rank_step_on_a_mesh, (2, 2), AXES)
    assert all(isinstance(x, float) and math.isfinite(x) for x in losses)
    assert len(set(losses)) == 1
    for msg in pool.run(_rank_step_on_a_mesh, (2, 2), ("data", "expert")):
        assert "must be among" in msg and "expert" in msg


# -------------------------------------------- one-device mesh, in process
@pytest.fixture()
def one_device_mesh():
    assert not dist.is_initialized()
    mesh = tmesh.make_mesh((1, 1), AXES, device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_one_device_dtensor_state_steps_and_saves_like_the_plain_state(
        one_device_mesh, tmp_path):
    """A state restored onto a one-device mesh trains through its local
    tensors, bit for bit as the plain state, and saves the same files."""
    from torch.distributed.tensor import DTensor
    mesh = one_device_mesh
    plain = init_train_state(CFG, 0, device="cpu")
    engine = EngineConfig(codec="blosc")
    ckpt.save_checkpoint(tmp_path / "a", plain, 2, engine_config=engine)
    shardings = train_state_shardings(CFG, mesh)
    dstate, step = ckpt.restore_sharded(tmp_path / "a",
                                        train_state_shapes(CFG), shardings)
    assert step == 2
    assert all(isinstance(t, DTensor) for t in tree_leaves(dstate))
    batch = to_device(SyntheticTokens(CFG.padded_vocab, 16, 2, seed=0)
                      .batch_at(0), "cpu")
    fn = make_train_step(CFG, AdamWConfig(warmup_steps=1), q_chunk=16,
                         kv_chunk=16)
    _, m_plain = fn(plain, batch)
    out, m_d = fn(dstate, batch)
    assert out is dstate and int(dstate["step"].to_local()) == 1
    assert float(m_plain["loss"]) == float(m_d["loss"])
    for a, b in zip(tree_leaves(plain), tree_leaves(dstate)):
        assert isinstance(b, DTensor) and torch.equal(a, b.to_local())
    for sub, state in (("plain", plain), ("dtensor", dstate)):
        ckpt.save_checkpoint(tmp_path / sub, state, 3, engine_config=engine,
                             device_compress=True)
    p, d = (ckpt.checkpoint_path(tmp_path / s, 3) for s in ("plain",
                                                             "dtensor"))
    for name in sorted(x.name for x in p.iterdir()):
        if name.startswith("data.") or name == "md.0":
            assert (p / name).read_bytes() == (d / name).read_bytes(), name
    # through the manager too
    mgr = CheckpointManager(tmp_path / "mgr", async_write=False,
                            device_compress=True, engine_config=engine)
    mgr.save(dstate, 3, force=True)
    back, step = mgr.restore_latest(train_state_shapes(CFG),
                                    shardings=shardings)
    assert step == 3
    for a, b in zip(tree_leaves(plain), tree_leaves(back)):
        assert torch.equal(a, b.to_local())
