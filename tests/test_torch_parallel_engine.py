"""The port's multi-process parallel write plane
(`repro_torch.core.parallel_engine`), case by case as the JAX package's
`tests/test_parallel_engine.py` holds its own: W-process parity with the
sync single-process writer, two-phase commit semantics, torn-shard
recovery, and the parallel_io wiring through Series / PIC / checkpoints.
Then what only the port has to show: the same puts give the same bytes as
the JAX package's plane, tensor chunks (shuffled by the coordinator or
copied to host) give the bytes numpy chunks give, and nothing but numpy
bytes crosses to a worker.

A worker imports torch, which makes every spawn a few seconds dearer than
the JAX package's; the cases that need no fresh processes share one
module-scoped plane of 4 writers."""
import json
import struct

import numpy as np
import pytest
import torch

from repro.core.parallel_engine import ParallelBpWriter as JParallelBpWriter
from repro.core.bp_engine import EngineConfig as JEngineConfig
from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig
from repro_torch.core.darshan import CTR, MONITOR
from repro_torch.core.dxt import TRACER
from repro_torch.core.metrics import METRICS
from repro_torch.core.parallel_engine import (ParallelBpWriter, WriterPlane,
                                              iter_shard_records, shard_path)
from repro_torch.core.shm_transport import ShmHeader
from repro_torch.core.striping import StripeConfig

IDX = struct.Struct("<QQQIIQQQ")     # md.idx record; field 5 is t_ns


@pytest.fixture(autouse=True)
def fresh_port_planes():
    MONITOR.reset()
    METRICS.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if TRACER.enabled:
        TRACER.disable()
        TRACER.reset()
    if METRICS.enabled:
        METRICS.disable()
    METRICS.reset()
    MONITOR.reset()


@pytest.fixture(scope="module")
def plane():
    with WriterPlane(4) as p:
        yield p


def _write_series(cls, path, *, n_ranks=8, codec="none", steps=3,
                  stripe=None, fsync_policy="close", cfg_cls=EngineConfig,
                  as_tensor=False, device_compress=False, **kw):
    cfg = cfg_cls(aggregators=4, codec=codec, workers=3, stripe=stripe,
                  n_osts=4, fsync_policy=fsync_policy,
                  device_compress=device_compress)
    w = cls(path, n_ranks, cfg, **kw)
    rng = np.random.default_rng(11)
    truth = {}
    for s in range(steps):
        w.begin_step(s)
        g = rng.normal(size=(n_ranks * 16, 4)).astype(np.float32)
        truth[s] = g
        for r in range(n_ranks):
            chunk = g[r * 16:(r + 1) * 16]
            w.put("var/x", torch.from_numpy(chunk.copy()) if as_tensor
                  else chunk, global_shape=g.shape, offset=(r * 16, 0),
                  rank=r)
        w.put("scalar/t", np.array([s], np.int64), global_shape=(1,),
              offset=(0,), rank=0)
        w.end_step()
    w.close()
    return truth


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("codec", ["none", "blosc"])
def test_parallel_matches_sync_byte_for_byte(tmpdir_path, plane, codec):
    """W=4 writer processes must produce data.*/md.0 byte-identical to the
    single-process sync writer for the same puts."""
    truth = _write_series(BpWriter, tmpdir_path / "sync.bp4", codec=codec)
    _write_series(ParallelBpWriter, tmpdir_path / "par.bp4", codec=codec,
                  n_writers=4, plane=plane)
    for name in ["data.0", "data.1", "data.2", "data.3", "md.0"]:
        a = (tmpdir_path / "sync.bp4" / name).read_bytes()
        b = (tmpdir_path / "par.bp4" / name).read_bytes()
        assert a == b, f"{name} differs between sync and parallel writes"
    r = BpReader(tmpdir_path / "par.bp4")
    assert r.valid_steps() == [0, 1, 2]
    for s, g in truth.items():
        np.testing.assert_array_equal(r.read_var(s, "var/x"), g)
        np.testing.assert_array_equal(r.read_var(s, "scalar/t"),
                                      np.array([s], np.int64))
    rs = BpReader(tmpdir_path / "sync.bp4")
    assert rs.variables() == r.variables()
    assert rs.layout() == r.layout()


def test_parallel_box_selection_across_subfiles(tmpdir_path, plane):
    truth = _write_series(ParallelBpWriter, tmpdir_path / "p.bp4",
                          n_writers=4, plane=plane)
    r = BpReader(tmpdir_path / "p.bp4")
    sel = r.read_var(1, "var/x", offset=(24, 1), extent=(80, 2))
    np.testing.assert_array_equal(sel, truth[1][24:104, 1:3])


def test_parallel_striped_roundtrip(tmpdir_path, plane):
    """Each writer process stripes its own subfile over the shared OST
    dirs; the striped layout reads back through the standard reader."""
    truth = _write_series(ParallelBpWriter, tmpdir_path / "p.bp4",
                          n_writers=2, n_ranks=4, steps=2, plane=plane,
                          stripe=StripeConfig(stripe_count=2, stripe_size=256))
    r = BpReader(tmpdir_path / "p.bp4")
    np.testing.assert_array_equal(r.read_var(1, "var/x"), truth[1])


def test_parallel_writer_count_clamped(tmpdir_path, plane):
    """n_writers > n_ranks clamps like aggregators do (one process per
    rank at most)."""
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 2, EngineConfig(),
                         n_writers=8, plane=plane)
    assert w.m == 2
    w.begin_step(0)
    w.put("v", np.arange(4, dtype=np.float32), global_shape=(4,),
          offset=(0,), rank=1)
    w.end_step()
    w.close()
    assert len(list((tmpdir_path / "p.bp4").glob("data.*"))) == 2


def test_parallel_put_rank_validation(tmpdir_path, plane):
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 4, EngineConfig(),
                         n_writers=2, plane=plane)
    w.begin_step(0)
    with pytest.raises(ValueError, match="rank=4"):
        w.put("v", np.zeros(4, np.float32), global_shape=(4,), offset=(0,),
              rank=4)
    w.put("v", torch.zeros(4), global_shape=(4,), offset=(0,), rank=0)
    w.end_step()
    w.close()


# -------------------------------------------------------- two-phase commit
def test_crash_between_prepare_and_commit_drops_step(tmpdir_path, plane):
    """Shards sealed (phase 1) but no md.idx record (phase 2 never ran):
    the step must be invisible to the reader."""
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 4, EngineConfig(),
                         n_writers=2, plane=plane)
    w.begin_step(0)
    w.put("v", np.arange(8, dtype=np.float32), global_shape=(8,),
          offset=(0,), rank=0)
    w.end_step()
    w._crash_after_prepare = True
    w.begin_step(1)
    w.put("v", np.full(8, 9, np.float32), global_shape=(8,), offset=(0,),
          rank=0)
    with pytest.raises(RuntimeError, match="simulated coordinator crash"):
        w.end_step()
    w._crash_after_prepare = False
    w.close()
    assert [s for s, _ in iter_shard_records(tmpdir_path / "p.bp4", 0)] == \
        [0, 1]
    r = BpReader(tmpdir_path / "p.bp4")
    assert r.valid_steps() == [0]
    np.testing.assert_array_equal(r.read_var(0, "v"),
                                  np.arange(8, dtype=np.float32))


def test_torn_shard_tail_is_dropped_on_replay(tmpdir_path, plane):
    """A shard torn mid-record replays to exactly the sealed prefix."""
    _write_series(ParallelBpWriter, tmpdir_path / "p.bp4", n_writers=2,
                  n_ranks=4, steps=3, plane=plane)
    sp = shard_path(tmpdir_path / "p.bp4", 1)
    raw = sp.read_bytes()
    sp.write_bytes(raw[:len(raw) - 7])
    steps = [s for s, _ in iter_shard_records(tmpdir_path / "p.bp4", 1)]
    assert steps == [0, 1]
    from repro_torch.core.parallel_engine import SHARD_HDR
    _, ln0, _ = SHARD_HDR.unpack_from(raw, 0)
    raw2 = bytearray(raw)
    raw2[SHARD_HDR.size + ln0 + SHARD_HDR.size + 2] ^= 0xFF
    sp.write_bytes(bytes(raw2))
    assert [s for s, _ in iter_shard_records(tmpdir_path / "p.bp4", 1)] == [0]


def test_worker_error_aborts_step_not_series(tmpdir_path):
    """A worker-side failure (bad codec) aborts the step with the worker
    traceback surfaced; nothing is committed and close() still tears the
    plane down cleanly."""
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 2,
                         EngineConfig(codec="no-such-codec"), n_writers=2)
    w.begin_step(0)
    w.put("v", np.arange(4, dtype=np.float32), global_shape=(4,),
          offset=(0,), rank=0)
    with pytest.raises(RuntimeError, match="unknown codec"):
        w.end_step()
    w.close()
    assert BpReader(tmpdir_path / "p.bp4").valid_steps() == []
    assert all(not p.is_alive() for p, _ in w._workers)


def test_worker_shard_offset_survives_failed_step(tmpdir_path, monkeypatch):
    """A step that fails AFTER the shard grew must not desync the worker's
    record-offset accounting (the worker runs as a thread here)."""
    import queue as q
    import threading
    import zlib as _zlib

    from repro_torch.core import aggregation
    from repro_torch.core.parallel_engine import SHARD_HDR, _worker_main

    fail_once = {"armed": True}
    real_fsync = aggregation.SubfileSet.fsync_one

    def flaky_fsync(self, agg_id):
        if fail_once.pop("armed", None):
            raise OSError("injected transient fsync failure")
        return real_fsync(self, agg_id)

    monkeypatch.setattr(aggregation.SubfileSet, "fsync_one", flaky_fsync)
    task_q, result_q = q.Queue(), q.Queue()
    t = threading.Thread(
        target=_worker_main,
        args=(0, str(tmpdir_path), 1,
              EngineConfig(fsync_policy="step"), task_q, result_q),
        daemon=True)
    t.start()
    assert result_q.get(timeout=10)[0] == "ready"
    arr = np.arange(8, dtype=np.float32)
    task_q.put(("step", 0, [("v", 0, (0,), arr)]))
    tag, _, _, payload = result_q.get(timeout=10)
    assert tag == "error" and "injected transient fsync" in payload
    task_q.put(("step", 1, [("v", 0, (0,), arr * 2)]))
    tag, _, mstep, info = result_q.get(timeout=10)
    assert (tag, mstep) == ("prepared", 1)
    task_q.put(("close", None, None))
    assert result_q.get(timeout=10)[0] == "closed"
    t.join(timeout=10)
    assert not t.is_alive()
    raw = (tmpdir_path / "md.0.shard").read_bytes()
    rec = raw[info["shard_off"]:info["shard_off"] + info["shard_len"]]
    rstep, ln, crc = SHARD_HDR.unpack_from(rec, 0)
    blob = rec[SHARD_HDR.size:SHARD_HDR.size + ln]
    assert rstep == 1 and (_zlib.crc32(blob) & 0xFFFFFFFF) == crc


def test_fsync_step_policy_commits_each_step_durably(tmpdir_path, plane):
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 4,
                         EngineConfig(fsync_policy="step"), n_writers=2,
                         plane=plane)
    for s in range(2):
        w.begin_step(s)
        w.put("v", np.full(8, s, np.float32), global_shape=(8,),
              offset=(0,), rank=0)
        w.end_step()
        r = BpReader(tmpdir_path / "p.bp4")
        assert r.valid_steps() == list(range(s + 1))
    w.close()


def test_profiling_has_two_phase_timings(tmpdir_path, plane):
    _write_series(ParallelBpWriter, tmpdir_path / "p.bp4", n_writers=4,
                  steps=2, plane=plane)
    doc = json.loads((tmpdir_path / "p.bp4" / "profiling.json").read_text())
    assert doc["engine"] == "JBP(BP4-parallel)"
    assert doc["writers"] == 4
    for step in doc["steps"]:
        assert step["prepare_s"] > 0 and step["commit_s"] >= 0
        assert len(step["worker_s"]) >= 1


# ------------------------------------------------- persistent writer plane
def test_writer_plane_reused_across_series_same_pids(tmpdir_path):
    """Two series written through one WriterPlane reuse the SAME worker
    processes and both read back; shutdown ends them."""
    with WriterPlane(2) as own:
        pids = own.pids()
        for i in range(2):
            truth = _write_series(
                ParallelBpWriter, tmpdir_path / f"s{i}.bp4",
                n_ranks=4, steps=2, n_writers=2, plane=own)
            assert own.pids() == pids, "plane respawned between series"
            assert all(p.is_alive() for p, _ in own.workers)
            r = BpReader(tmpdir_path / f"s{i}.bp4")
            assert r.valid_steps() == [0, 1]
            np.testing.assert_array_equal(r.read_var(1, "var/x"), truth[1])
    for p, _ in own.workers:
        p.join(timeout=10)
    assert all(not p.is_alive() for p, _ in own.workers)


def test_writer_plane_output_byte_identical_to_owned_workers(tmpdir_path,
                                                             plane):
    _write_series(ParallelBpWriter, tmpdir_path / "own.bp4", n_ranks=4,
                  steps=2, n_writers=2)
    _write_series(ParallelBpWriter, tmpdir_path / "pl.bp4", n_ranks=4,
                  steps=2, n_writers=2, plane=plane)
    for name in ["data.0", "data.1", "md.0"]:
        assert (tmpdir_path / "own.bp4" / name).read_bytes() == \
            (tmpdir_path / "pl.bp4" / name).read_bytes(), name


def test_writer_plane_clamps_to_fewer_writers(tmpdir_path, plane):
    """A writer asking for more writers than the plane has uses the
    plane's worker count; asking for fewer opens only that many."""
    w = ParallelBpWriter(tmpdir_path / "a.bp4", 8, EngineConfig(),
                         n_writers=8, plane=plane)
    assert w.m == plane.m == 4
    w.begin_step(0)
    w.put("v", np.arange(8, dtype=np.float32), global_shape=(8,),
          offset=(0,), rank=0)
    w.end_step()
    w.close()
    w2 = ParallelBpWriter(tmpdir_path / "b.bp4", 8, EngineConfig(),
                          n_writers=1, plane=plane)
    assert w2.m == 1
    w2.begin_step(0)
    w2.put("v", np.arange(8, dtype=np.float32), global_shape=(8,),
           offset=(0,), rank=0)
    w2.end_step()
    w2.close()
    assert len(list((tmpdir_path / "b.bp4").glob("data.*"))) == 1


# --------------------------------------------- darshan counters from workers
def test_worker_darshan_counters_merged_into_parent(tmpdir_path, plane):
    """The workers' subfile and shard writes reach the coordinator's
    MONITOR on the 'finished' ack."""
    _write_series(ParallelBpWriter, tmpdir_path / "p.bp4", n_ranks=4,
                  steps=2, n_writers=2, plane=plane)
    rep = MONITOR.report()["files"]
    for w in (0, 1):
        data = [c for p, c in rep.items() if p.endswith(f"data.{w}")]
        assert data and data[0].get("POSIX_BYTES_WRITTEN", 0) > 0, \
            f"worker {w} subfile writes missing from the merged monitor"
        shard = [c for p, c in rep.items() if p.endswith(f"md.{w}.shard")]
        assert shard and shard[0].get("POSIX_BYTES_WRITTEN", 0) > 0
    assert "data.1" in MONITOR.parser_dump()


# ------------------------------------------------------------------- wiring
def test_series_parallel_io_roundtrip(tmpdir_path):
    from repro_torch.core.openpmd import Series
    s = Series(tmpdir_path / "d.bp4", "w", n_ranks=4,
               engine_config=EngineConfig(aggregators=2), parallel_io=2)
    it = s.iterations[0]
    rc = it.meshes["density"][""]
    arr = np.linspace(0, 1, 64, dtype=np.float32)
    rc.reset_dataset(arr.dtype, arr.shape)
    for r in range(4):
        rc.store_chunk(torch.from_numpy(arr[r * 16:(r + 1) * 16].copy()),
                       offset=(r * 16,), rank=r)
    s.flush()
    s.close()
    r = BpReader(tmpdir_path / "d.bp4")
    assert r.valid_steps() == [0]
    np.testing.assert_array_equal(
        r.read_var(0, "/data/0/meshes/density"), arr)


def test_series_validates_plane_combinations_up_front(tmpdir_path):
    from repro_torch.core.openpmd import Series
    with pytest.raises(ValueError,
                       match=r"Series\(parallel_io=2, async_commit=True\)"):
        Series(tmpdir_path / "d.bp4", "w", async_io=True, parallel_io=2)
    with pytest.raises(ValueError, match="requires parallel_io"):
        Series(tmpdir_path / "d.bp4", "w", async_commit=True)
    assert not (tmpdir_path / "d.bp4" / "md.0").exists()
    with pytest.raises(ValueError, match="unknown transport"):
        Series(tmpdir_path / "d.bp4", "w", parallel_io=2, transport="tcp")


def test_checkpoint_parallel_io_roundtrip(tmpdir_path):
    from repro_torch.ckpt.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "b": np.ones(8, dtype=np.float32),
             "step": np.int32(7)}
    save_checkpoint(tmpdir_path, state, 7, n_io_ranks=4, parallel_io=2)
    like = {"w": torch.zeros(8, 8), "b": np.zeros(8, np.float32),
            "step": np.int32(0)}
    restored, step = restore_checkpoint(tmpdir_path, like)
    assert step == 7
    assert torch.equal(restored["w"], state["w"])
    np.testing.assert_array_equal(restored["b"], state["b"])
    assert restored["step"] == 7


def test_pic_diagnostic_series_parallel_io(tmpdir_path):
    from repro_torch.pic.simulation import (PicConfig, init_sim,
                                            open_diagnostic_series,
                                            run_with_diagnostics)
    cfg = PicConfig(n_cells=64, capacity=1 << 9, n_electrons=256,
                    n_ions=256, n_neutrals=256)
    state = init_sim(cfg, 0, device="cpu")
    series = open_diagnostic_series(tmpdir_path / "diag.bp4", n_io_ranks=4,
                                    parallel_io=2)
    assert series.async_commit and not series.async_io
    run_with_diagnostics(state, cfg, series, n_chunks=2, steps_per_chunk=2,
                         n_io_ranks=4)
    series.close()
    r = BpReader(tmpdir_path / "diag.bp4")
    steps = r.valid_steps()
    assert len(steps) == 2
    dens = r.read_var(steps[0], "/data/%d/meshes/density_e" % steps[0])
    assert dens.shape == (64,) and np.isfinite(dens).all()


# ------------------------------------------------------ across the packages
def _idx_records(path):
    raw = (path / "md.idx").read_bytes()
    return [list(IDX.unpack_from(raw, o))
            for o in range(0, len(raw), IDX.size)]


@pytest.mark.parametrize("codec", ["none", "blosc"])
def test_same_puts_give_the_jax_planes_bytes(tmpdir_path, plane, codec):
    """The same numpy puts through the JAX package's ParallelBpWriter and
    the port's give equal data.* and md.0, and md.idx records that differ
    only in their t_ns field; each package reads the other's series."""
    from repro.core.bp_engine import BpReader as JBpReader
    truth = _write_series(JParallelBpWriter, tmpdir_path / "j.bp4",
                          codec=codec, n_writers=4, cfg_cls=JEngineConfig)
    _write_series(ParallelBpWriter, tmpdir_path / "t.bp4", codec=codec,
                  n_writers=4, plane=plane)
    for name in ["data.0", "data.1", "data.2", "data.3", "md.0"]:
        assert (tmpdir_path / "j.bp4" / name).read_bytes() == \
            (tmpdir_path / "t.bp4" / name).read_bytes(), name
    j, t = _idx_records(tmpdir_path / "j.bp4"), _idx_records(
        tmpdir_path / "t.bp4")
    assert len(j) == len(t) == 3
    for a, b in zip(j, t):
        assert a[:5] + a[6:] == b[:5] + b[6:]
    for reader_cls, path in ((JBpReader, tmpdir_path / "t.bp4"),
                             (BpReader, tmpdir_path / "j.bp4")):
        with reader_cls(path) as r:
            for s, g in truth.items():
                np.testing.assert_array_equal(r.read_var(s, "var/x"), g)


@pytest.mark.parametrize("device_compress", [False, True])
@pytest.mark.parametrize("async_commit", [False, True])
def test_tensor_puts_give_the_serial_engines_bytes(tmpdir_path, plane,
                                                   device_compress,
                                                   async_commit):
    """CPU tensor chunks, shuffled by the coordinator (`device_compress`:
    the plain version of the kernel, then pre-shuffled bytes to the
    workers) or copied to host, give the series the sync writer gives for
    the same puts (numpy chunks without `device_compress`; with it a block
    stored raw keeps its pre-shuffled flag, as on the serial device path);
    the device-shuffled bytes are counted once."""
    _write_series(BpWriter, tmpdir_path / "ref.bp4", codec="blosc",
                  as_tensor=device_compress, device_compress=device_compress)
    MONITOR.reset()
    _write_series(ParallelBpWriter, tmpdir_path / "t.bp4", codec="blosc",
                  n_writers=4, plane=plane, as_tensor=True,
                  device_compress=device_compress,
                  async_commit=async_commit)
    for name in ["data.0", "data.1", "data.2", "data.3", "md.0"]:
        assert (tmpdir_path / "ref.bp4" / name).read_bytes() == \
            (tmpdir_path / "t.bp4" / name).read_bytes(), name
    shuffled = MONITOR.report()["total"].get(CTR.COMPRESS_DEVICE_BYTES, 0)
    assert shuffled == (3 * 8 * 16 * 4 * 4 if device_compress else 0)


class _Recorder:
    """A writer's task queue that keeps what was put on it."""

    def __init__(self, q, log):
        self.q, self.log = q, log

    def put(self, msg):
        self.log.append(msg)
        self.q.put(msg)

    def close(self):
        self.q.close()


@pytest.mark.parametrize("transport", ["shm", "pickle"])
@pytest.mark.parametrize("device_compress", [False, True])
def test_only_numpy_bytes_cross_to_a_worker(tmpdir_path, transport,
                                            device_compress):
    """What goes down a worker's queue is an ndarray, a `ShmHeader`, or a
    pre-shuffled chunk's raw bytes with its metadata: never a tensor. A
    16 KiB ring takes the small chunks and spills the large ones to the
    pickle path."""
    cfg = EngineConfig(aggregators=2, codec="blosc",
                       device_compress=device_compress)
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 4, cfg, n_writers=2,
                         transport=transport, ring_bytes=1 << 14)
    log = []
    w._workers = [(p, _Recorder(q, log)) for p, q in w._workers]
    rng = np.random.default_rng(3)
    big = rng.normal(size=(4, 8192)).astype(np.float32)
    small = rng.normal(size=(4, 256)).astype(np.float32)
    w.begin_step(0)
    for r in range(4):
        w.put("big", torch.from_numpy(big[r:r + 1].copy()),
              global_shape=big.shape, offset=(r, 0), rank=r)
        w.put("small", torch.from_numpy(small[r:r + 1].copy()),
              global_shape=small.shape, offset=(r, 0), rank=r)
    w.end_step()
    w.close()
    items = [it for tag, *rest in log if tag == "step" for it in rest[1]]
    assert len(items) == 8
    kinds = set()
    for item in items:
        chunk = item[3]
        assert not isinstance(chunk, torch.Tensor)
        assert isinstance(chunk, (np.ndarray, ShmHeader))
        kinds.add(type(chunk))
        pre = item[4].get("pre") if len(item) > 4 else None
        assert (pre is not None) == device_compress
        if pre is not None:
            assert pre["dtype"] == "<f4" and isinstance(pre["vmin"], float)
    if transport == "shm":
        assert kinds == {np.ndarray, ShmHeader}
    else:
        assert kinds == {np.ndarray}
    with BpReader(tmpdir_path / "p.bp4") as r:
        np.testing.assert_array_equal(r.read_var(0, "big"), big)
        np.testing.assert_array_equal(r.read_var(0, "small"), small)

