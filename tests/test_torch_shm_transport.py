"""The port's shared-memory chunk transport (`repro_torch.core.shm_transport`)
and the async∘parallel composition, case by case as the JAX package's
`tests/test_shm_transport.py` holds its own: the ShmRing allocator
(wrap-around, FIFO free-list, pow2 slots, oversize spill), transport parity
(shm and pickle series are bit-identical), crash consistency (a worker
SIGKILLed while ring slots are in flight drops the step like a torn shard
and leaks nothing in /dev/shm), the hardened close path, and
`Series(parallel_io=W, async_commit=True)`. The manager's case with a
killed plane worker is in `test_torch_ckpt.py`.

Cases that need no fresh processes share one module-scoped plane of 4
writers: a worker imports torch, so each spawn costs seconds."""
import json
import os
import pathlib
import signal

import numpy as np
import pytest
import torch

from _propcheck import given, settings, strategies as st
from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig
from repro_torch.core.darshan import MONITOR
from repro_torch.core.parallel_engine import ParallelBpWriter, WriterPlane
from repro_torch.core.shm_transport import MIN_SLOT, ShmRing


@pytest.fixture(autouse=True)
def fresh_port_monitor():
    MONITOR.reset()
    yield
    MONITOR.reset()


@pytest.fixture(scope="module")
def plane():
    with WriterPlane(4) as p:
        yield p


def _ring_exists(name: str) -> bool:
    return pathlib.Path(f"/dev/shm/{name}").exists()


def _write_series(cls, path, *, n_ranks=8, codec="none", steps=3,
                  as_tensor=False, **kw):
    cfg = EngineConfig(aggregators=4, codec=codec, workers=3)
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
        w.end_step()
    if hasattr(w, "drain"):
        w.drain()
    w.close()
    return truth


# ------------------------------------------------------------------ ShmRing
def test_ring_pow2_slots_and_oversize_spill():
    r = ShmRing(1 << 16)
    assert r.slot_len(1) == MIN_SLOT
    assert r.slot_len(MIN_SLOT + 1) == 2 * MIN_SLOT
    assert r.write_array(np.zeros(r.capacity + 1, np.uint8)) is None
    r.close()
    r.unlink()


def test_ring_wraparound_preserves_contents():
    r = ShmRing(1 << 16)
    att = ShmRing(name=r.name, create=False)
    first = [r.write_array(np.full(1000, i, np.float32)) for i in range(8)]
    tailh = r.write_array(np.arange(8192, dtype=np.float32))
    for h in first:
        r.free(h.offset)
    wrapped = r.write_array(np.full(1500, 9, np.float32))
    assert wrapped is not None and wrapped.offset == 0
    np.testing.assert_array_equal(att.view(tailh),
                                  np.arange(8192, dtype=np.float32))
    assert (att.view(wrapped) == 9).all()
    r.free(tailh.offset)
    r.free(wrapped.offset)
    assert r.free_bytes() == r.capacity
    att.close()
    r.close()
    r.unlink()


def test_ring_free_is_fifo_only():
    r = ShmRing(1 << 16)
    a = r.write_array(np.zeros(100, np.float32))
    b = r.write_array(np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="out-of-order free"):
        r.free(b.offset)
    r.free(a.offset)
    r.free(b.offset)
    r.close()
    r.unlink()


@settings(max_examples=25, deadline=None)
@given(sizes=st.lists(st.integers(min_value=1, max_value=24 * 1024),
                      min_size=1, max_size=40),
       capacity_kib=st.sampled_from([16, 64, 256]))
def test_ring_alloc_free_property(sizes, capacity_kib):
    """Under any alloc/free interleaving (free oldest whenever the ring
    refuses), every live slot's contents stay intact until ITS free, and
    draining the FIFO returns the ring to empty."""
    ring = ShmRing(capacity_kib * 1024)
    try:
        live: list = []
        for i, nbytes in enumerate(sizes):
            arr = np.full(max(nbytes // 4, 1), i, np.int32)
            hdr = ring.write_array(arr)
            while hdr is None and live:
                h, v = live.pop(0)
                assert (ring.view(h) == v).all(), "slot corrupted while live"
                ring.free(h.offset)
                hdr = ring.write_array(arr)
            if hdr is None:
                continue
            live.append((hdr, i))
        for h, v in live:
            assert (ring.view(h) == v).all()
            ring.free(h.offset)
        assert ring.free_bytes() == ring.capacity
    finally:
        ring.close()
        ring.unlink()


def test_ring_copies_a_pinned_style_tensor_view():
    """A pre-shuffled chunk's bytes are a numpy view of a torch buffer;
    the ring copies them, so the buffer may go once write_array returns."""
    r = ShmRing(1 << 16)
    buf = torch.arange(4096, dtype=torch.uint8)
    hdr = r.write_array(buf.numpy())
    expect = buf.numpy().copy()
    buf.zero_()
    del buf
    np.testing.assert_array_equal(r.view(hdr), expect)
    r.free(hdr.offset)
    r.close()
    r.unlink()


# ------------------------------------------------------------------- parity
def test_shm_and_pickle_transports_bit_identical_w4(tmpdir_path, plane):
    """The transport moves bytes, it must not change them: shm- and
    pickle-transport series at W=4 are bit-identical to each other AND to
    the single-process sync writer."""
    truth = _write_series(BpWriter, tmpdir_path / "sync.bp4", codec="blosc")
    _write_series(ParallelBpWriter, tmpdir_path / "shm.bp4", codec="blosc",
                  n_writers=4, plane=plane)
    _write_series(ParallelBpWriter, tmpdir_path / "pkl.bp4", codec="blosc",
                  n_writers=4, transport="pickle", as_tensor=True)
    assert plane.transport == "shm"
    for name in ["data.0", "data.1", "data.2", "data.3", "md.0"]:
        ref = (tmpdir_path / "sync.bp4" / name).read_bytes()
        assert (tmpdir_path / "shm.bp4" / name).read_bytes() == ref, name
        assert (tmpdir_path / "pkl.bp4" / name).read_bytes() == ref, name
    r = BpReader(tmpdir_path / "shm.bp4")
    np.testing.assert_array_equal(r.read_var(2, "var/x"), truth[2])
    r.close()


def test_tiny_ring_spills_to_pickle_fallback_with_parity(tmpdir_path, plane):
    """A ring too small for the step's chunks degrades per chunk to the
    pickle path — same bytes on disk, fallback visible in profiling."""
    _write_series(ParallelBpWriter, tmpdir_path / "ref.bp4", n_writers=2,
                  plane=plane)
    cfg = EngineConfig(aggregators=2, codec="none", workers=3,
                       profiling=True)
    w = ParallelBpWriter(tmpdir_path / "tiny.bp4", 8, cfg, n_writers=2,
                         transport="shm", ring_bytes=2 * MIN_SLOT)
    rng = np.random.default_rng(11)
    prof = None
    for s in range(3):
        w.begin_step(s)
        g = rng.normal(size=(8 * 16, 4)).astype(np.float32)
        for r in range(8):
            w.put("var/x", g[r * 16:(r + 1) * 16],
                  global_shape=g.shape, offset=(r * 16, 0), rank=r)
        prof = w.end_step()
    w.close()
    assert prof["transport_pickle_bytes"] > 0, "nothing spilled"
    assert prof["transport_shm_bytes"] > 0, "nothing went through the ring"
    for name in ["data.0", "data.1", "md.0"]:
        assert (tmpdir_path / "tiny.bp4" / name).read_bytes() == \
            (tmpdir_path / "ref.bp4" / name).read_bytes(), name


# -------------------------------------------------------- crash consistency
def test_worker_sigkill_with_slot_in_flight_drops_step(tmpdir_path):
    """SIGKILL a writer process while its ring slots are in flight: the
    step aborts uncommitted, the context manager still exits, the rings
    are unlinked, and a fresh writer succeeds at once."""
    cfg = EngineConfig(aggregators=2, codec="none", workers=3)
    with ParallelBpWriter(tmpdir_path / "p.bp4", 4, cfg, n_writers=2,
                          transport="shm", ack_timeout=60.0) as w:
        ring_names = [r.name for r in w._rings]
        w.begin_step(0)
        w.put("v", np.arange(8, dtype=np.float32), global_shape=(8,),
              offset=(0,), rank=0)
        w.end_step()
        os.kill(w._workers[1][0].pid, signal.SIGKILL)
        w.begin_step(1)
        for r in range(4):                   # rank 2/3 route to dead worker 1
            w.put("v", torch.full((8,), float(r)), global_shape=(32,),
                  offset=(8 * r,), rank=r)
        with pytest.raises(RuntimeError, match="died before acking"):
            w.end_step()
    assert all(not p.is_alive() for p, _ in w._workers)
    assert not any(_ring_exists(n) for n in ring_names), "ring leaked"
    r = BpReader(tmpdir_path / "p.bp4")
    assert r.valid_steps() == [0]
    np.testing.assert_array_equal(r.read_var(0, "v"),
                                  np.arange(8, dtype=np.float32))
    r.close()
    _write_series(ParallelBpWriter, tmpdir_path / "next.bp4", n_ranks=4,
                  steps=1, n_writers=2, transport="shm")
    assert BpReader(tmpdir_path / "next.bp4").valid_steps() == [0]


def test_worker_killed_mid_step_close_does_not_hang(tmpdir_path):
    """A coordinator exception with a dead worker and undrained queues must
    not hang close()."""
    cfg = EngineConfig(aggregators=2, codec="none", workers=3)
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 4, cfg, n_writers=2,
                         transport="pickle", ack_timeout=60.0)
    w.begin_step(0)
    for r in range(4):
        w.put("v", np.full(1024, r, np.float32), global_shape=(4096,),
              offset=(1024 * r,), rank=r)
    os.kill(w._workers[0][0].pid, signal.SIGKILL)
    with pytest.raises(RuntimeError, match="died before acking"):
        w.end_step()
    w.close()                                # must return, not hang
    w.close()                                # idempotent
    assert all(not p.is_alive() for p, _ in w._workers)


def test_async_commit_worker_failure_surfaces_on_drain(tmpdir_path):
    """A background two-phase commit that fails latches the error and
    surfaces it at the next producer call; nothing is committed."""
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 2,
                         EngineConfig(codec="no-such-codec"), n_writers=2,
                         async_commit=True)
    w.begin_step(0)
    w.put("v", np.arange(4, dtype=np.float32), global_shape=(4,),
          offset=(0,), rank=0)
    w.end_step()
    with pytest.raises(RuntimeError, match="unknown codec"):
        w.drain()
    with pytest.raises(RuntimeError, match="unknown codec"):
        w.close()
    w.close()
    assert BpReader(tmpdir_path / "p.bp4").valid_steps() == []


# ------------------------------------------------------------- composition
def test_series_async_commit_roundtrip_and_barrier(tmpdir_path):
    """Tensor chunks flushed through `Series(parallel_io=2,
    async_commit=True)` are snapshot (cloned) at flush: the producer
    changes them in place at once, and the series holds the values at
    flush."""
    from repro_torch.core.openpmd import Series
    s = Series(tmpdir_path / "d.bp4", "w", n_ranks=4,
               engine_config=EngineConfig(aggregators=2), parallel_io=2,
               async_commit=True)
    arr = np.linspace(0, 1, 64, dtype=np.float32)
    buf = torch.from_numpy(arr.copy())
    expect = []
    for it_idx in range(3):
        it = s.iterations[it_idx]
        rc = it.meshes["density"][""]
        rc.reset_dataset(arr.dtype, arr.shape)
        for r in range(4):
            rc.store_chunk(buf[r * 16:(r + 1) * 16], offset=(r * 16,),
                           rank=r)
        it.close()                           # flush: snapshot + enqueue only
        expect.append(buf.numpy().copy())
        buf.add_(1.0)                        # the producer moves on
    s.drain()
    r = BpReader(tmpdir_path / "d.bp4")
    assert r.valid_steps() == [0, 1, 2]
    s.close()
    r = BpReader(tmpdir_path / "d.bp4")
    for it_idx in range(3):
        np.testing.assert_array_equal(
            r.read_var(it_idx, f"/data/{it_idx}/meshes/density"),
            expect[it_idx])
    r.close()


def test_async_commit_output_byte_identical_to_sync_plane(tmpdir_path,
                                                          plane):
    _write_series(BpWriter, tmpdir_path / "sync.bp4")
    _write_series(ParallelBpWriter, tmpdir_path / "par.bp4", n_writers=4,
                  plane=plane)
    _write_series(ParallelBpWriter, tmpdir_path / "ac.bp4", n_writers=4,
                  async_commit=True, plane=plane)
    for name in ["data.0", "data.1", "data.2", "data.3", "md.0"]:
        ref = (tmpdir_path / "sync.bp4" / name).read_bytes()
        assert (tmpdir_path / "par.bp4" / name).read_bytes() == ref, name
        assert (tmpdir_path / "ac.bp4" / name).read_bytes() == ref, name


def test_async_commit_fsync_step_forces_blocking_seal(tmpdir_path, plane):
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 4,
                         EngineConfig(fsync_policy="step"), n_writers=2,
                         async_commit=True, plane=plane)
    for s in range(2):
        w.begin_step(s)
        w.put("v", np.full(8, s, np.float32), global_shape=(8,),
              offset=(0,), rank=0)
        prof = w.end_step()
        assert "queued" not in prof
        assert BpReader(tmpdir_path / "p.bp4").valid_steps() == \
            list(range(s + 1))
    w.close()


def test_async_commit_profiling_has_overlap_block(tmpdir_path, plane):
    cfg = EngineConfig(aggregators=2, codec="none", workers=3,
                       profiling=True)
    w = ParallelBpWriter(tmpdir_path / "q.bp4", 4, cfg, n_writers=2,
                         async_commit=True, plane=plane)
    w.begin_step(0)
    w.put("v", np.arange(8, dtype=np.float32), global_shape=(8,),
          offset=(0,), rank=0)
    prof = w.end_step()
    assert prof.get("queued") is True
    w.close()
    doc = json.loads((tmpdir_path / "q.bp4" / "profiling.json").read_text())
    assert doc["transport"] == "shm"
    assert doc["async"]["queue_depth"] >= 1
    assert doc["steps"][0]["transport_shm_bytes"] > 0


# -------------------------------------------------------- plane ring reuse
def test_writer_plane_rings_persist_across_series_and_unlink(tmpdir_path):
    with WriterPlane(2) as own:
        names = [r.name for r in own.rings]
        assert len(names) == 2 and all(_ring_exists(n) for n in names)
        for i in range(2):
            _write_series(ParallelBpWriter, tmpdir_path / f"s{i}.bp4",
                          n_ranks=4, steps=2, n_writers=2, plane=own)
            assert [r.name for r in own.rings] == names
            assert all(_ring_exists(n) for n in names)
    assert not any(_ring_exists(n) for n in names), "plane leaked rings"
    for i in range(2):
        assert BpReader(tmpdir_path / f"s{i}.bp4").valid_steps() == [0, 1]
