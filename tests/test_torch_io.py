"""The port's I/O planes (`repro_torch.core`) against the JAX package's
`repro.core`: the same arrays give the same bytes on disk, each package
reads the other's series, and the device codec on a CPU tensor encodes
exactly as the JAX device path and the host path do."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import BpReader as JBpReader
from repro.core import EngineConfig as JEngineConfig
from repro.core import Series as JSeries
from repro.core import compression as JC
from repro_torch.core import BpReader, EngineConfig, Series
from repro_torch.core import compression as C
from repro_torch.core.darshan import CTR, MONITOR


@pytest.fixture(autouse=True)
def fresh_port_monitor():
    MONITOR.reset()
    yield
    MONITOR.reset()


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rho": rng.normal(size=4096).astype(np.float32),
        "count": rng.integers(0, 1 << 40, 1000, dtype=np.int64),
        "v": rng.normal(size=(512, 3)),
        "flat": np.linspace(0, 1, 777, dtype=np.float32),
    }


def _write(series_cls, path, arrays, n_ranks=8, **kw):
    """One variable per iteration: the order of the variables inside one
    engine step follows the JAX Series' set of dirty components, which
    is not deterministic, so a byte comparison keeps one per step."""
    s = series_cls(path, "w", n_ranks=n_ranks, **kw)
    for step, (name, arr) in enumerate(arrays.items()):
        it = s.iterations[step]
        it.time = step * 0.5
        rc = it.meshes[name][""]
        rc.reset_dataset(arr.dtype, arr.shape)
        bounds = np.linspace(0, arr.shape[0], n_ranks + 1).astype(int)
        for r in range(n_ranks):
            lo, hi = int(bounds[r]), int(bounds[r + 1])
            rc.store_chunk(arr[lo:hi], offset=(lo,) + (0,) * (arr.ndim - 1),
                           rank=r)
        s.flush()
    s.close()


def _same_files(a, b, names):
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_series_bytes_identical_and_cross_readable(tmpdir_path):
    arrays = _arrays()
    kw = dict(aggregators=4, codec="blosc", workers=4)
    _write(JSeries, tmpdir_path / "j.bp4", arrays,
           engine_config=JEngineConfig(**kw))
    _write(Series, tmpdir_path / "t.bp4", arrays,
           engine_config=EngineConfig(**kw))
    j, t = tmpdir_path / "j.bp4", tmpdir_path / "t.bp4"
    _same_files(j, t, ["md.0"] + [f"data.{i}" for i in range(4)])
    for reader_cls, path in ((JBpReader, t), (BpReader, j)):
        with reader_cls(path) as r:
            assert r.valid_steps() == list(range(len(arrays)))
            for step, (name, arr) in enumerate(arrays.items()):
                got = r.read_var(step, f"/data/{step}/meshes/{name}")
                np.testing.assert_array_equal(got, arr)


def test_tensor_chunks_with_device_compress_match_jax_series(tmpdir_path):
    """A CPU tensor takes the port's device codec (the plain shuffle); a
    jax array takes the JAX package's. The series must be identical."""
    arrays = {k: v for k, v in _arrays(1).items() if k in ("rho", "flat")}
    kw = dict(aggregators=2, codec="blosc", workers=2, device_compress=True)
    jpath, tpath = tmpdir_path / "j.bp4", tmpdir_path / "t.bp4"
    for series_cls, cfg, conv in (
            (JSeries, JEngineConfig(**kw), jnp.asarray),
            (Series, EngineConfig(**kw), torch.from_numpy)):
        s = series_cls(jpath if conv is jnp.asarray else tpath, "w",
                       n_ranks=4, engine_config=cfg)
        for step, (name, arr) in enumerate(arrays.items()):
            rc = s.iterations[step].meshes[name][""]
            rc.reset_dataset(arr.dtype, arr.shape)
            half = arr.shape[0] // 2
            rc.store_chunk(conv(arr[:half].copy()),
                           offset=(0,) + (0,) * (arr.ndim - 1), rank=0)
            rc.store_chunk(conv(arr[half:].copy()),
                           offset=(half,) + (0,) * (arr.ndim - 1), rank=3)
            s.flush()
        s.close()
    _same_files(jpath, tpath, ["md.0", "data.0", "data.1"])
    expect = sum(a.nbytes for a in arrays.values())
    assert MONITOR.report()["total"][CTR.COMPRESS_DEVICE_BYTES] == expect
    with JBpReader(tpath) as r:
        for step, (name, arr) in enumerate(arrays.items()):
            np.testing.assert_array_equal(
                r.read_var(step, f"/data/{step}/meshes/{name}"), arr)


# float32 / int16 / int32: types the JAX package keeps (x64 is off there)
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int32])
@pytest.mark.parametrize("block", [999, 4096, C.DEFAULT_BLOCK])
def test_device_codec_on_cpu_tensor_matches_jax_and_host(dtype, block):
    rng = np.random.default_rng(5)
    arr = (rng.normal(size=3001) * 100).astype(dtype)
    tp, ts = C.device_array_payload(torch.from_numpy(arr), "blosc", block)
    jp, js = JC.device_array_payload(jnp.asarray(arr), "blosc", block)
    assert tp == jp
    assert ts.device_bytes == js.device_bytes
    assert (ts.vmin, ts.vmax) == (float(arr.min()), float(arr.max()))
    np.testing.assert_array_equal(C.payload_to_array(tp, arr.dtype,
                                                     arr.shape), arr)
    # block boundaries mirror the host encoder: a block whose length is
    # not a multiple of itemsize passes through unshuffled on both sides
    chunk = C.device_precondition(torch.from_numpy(arr), block=block)
    raw = arr.tobytes()
    host = b"".join(C.byte_shuffle(raw[i:i + block], arr.itemsize)
                    for i in range(0, len(raw), block))
    assert chunk.data.tobytes() == host
    jchunk = JC.device_precondition(jnp.asarray(arr), block=block)
    assert chunk.data.tobytes() == jchunk.data.tobytes()
    if all(len(raw[i:i + block]) % arr.itemsize == 0
           for i in range(0, len(raw), block)):
        # every block shuffled and compressed: the host path's bytes
        assert tp == JC.array_payload(arr, "blosc", block)


def test_device_codec_float64_round_trips_like_host():
    arr = np.random.default_rng(6).normal(size=5000) * 1e3
    for block in (1001, 4000):      # 1001 % 8 != 0: blocks pass through
        tp, ts = C.device_array_payload(torch.from_numpy(arr), "blosc", block)
        np.testing.assert_array_equal(
            C.payload_to_array(tp, arr.dtype, arr.shape), arr)
        chunk = C.device_precondition(torch.from_numpy(arr), block=block)
        raw = arr.tobytes()
        assert chunk.data.tobytes() == b"".join(
            C.byte_shuffle(raw[i:i + block], 8)
            for i in range(0, len(raw), block))
        assert ts.device_bytes == (len(raw) if block % 8 == 0 else 0)


def _payload_block_by_block(arr, block):
    """The device codec block by block: `shuffle_block` on each codec
    block whose length is a multiple of the item size, each block then
    encoded as pre-shuffled; the one-launch path must match it byte for
    byte."""
    from repro_torch.kernels.bitshuffle import ops as bops
    raw, isz = arr.tobytes(), arr.dtype.itemsize
    chunk, payload = [], []
    for i in range(0, max(len(raw), 1), block):
        b = np.frombuffer(raw[i:i + block], np.uint8)
        shuf = isz > 1 and len(b) > 0 and len(b) % isz == 0
        if shuf:
            b = bops.shuffle_block(torch.from_numpy(b.copy()),
                                   itemsize=isz).numpy()
        chunk.append(b.tobytes())
        payload.append(C._compress_block(b.tobytes(), "blosc", isz,
                                         preshuffled=shuf))
    return b"".join(payload), b"".join(chunk)


# smooth (compressible) and random (stored raw, the pre-shuffled flag
# kept) data; one item, a leaf shorter than a block, an exact multiple, a
# ragged last block, a last block not a multiple of the item size, and
# blocks that are not (999, 1001)
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32,
                                   np.float64])
@pytest.mark.parametrize("n,block", [(1, 4096), (300, 4096), (2048, 4096),
                                     (3000, 4096), (3001, 999),
                                     (2500, 1001)])
def test_device_codec_payload_is_what_block_by_block_gave(dtype, n, block):
    rng = np.random.default_rng(n + block)
    for arr in ((np.linspace(0, 50, n) * 7).astype(dtype),
                rng.integers(0, 120, n).astype(dtype)):
        expect_payload, expect_chunk = _payload_block_by_block(arr, block)
        payload, stats = C.device_array_payload(torch.from_numpy(arr),
                                                "blosc", block)
        assert payload == expect_payload
        chunk = C.device_precondition(torch.from_numpy(arr), block=block)
        assert chunk.data.tobytes() == expect_chunk
        assert chunk.device_bytes == stats.device_bytes
        np.testing.assert_array_equal(
            C.payload_to_array(payload, arr.dtype, arr.shape), arr)


def test_device_codec_shuffles_a_leaf_in_one_call(monkeypatch):
    from repro_torch.kernels.bitshuffle import ops as bops
    calls = []

    def counting(data, *, block, itemsize):
        calls.append((int(data.shape[0]), block, itemsize))
        return bops.shuffle_blocks_ref(data, block=block, itemsize=itemsize)

    def forbidden(*a, **kw):
        raise AssertionError("the write path shuffles per leaf, not per "
                             "block")

    monkeypatch.setattr(bops, "shuffle_blocks", counting)
    monkeypatch.setattr(bops, "shuffle_block", forbidden)
    arr = np.arange(10_000, dtype=np.float32)
    payload, stats = C.device_array_payload(torch.from_numpy(arr), "blosc",
                                            4096)
    assert calls == [(40_000, 4096, 4)] and stats.device_bytes == 40_000
    assert payload == JC.array_payload(arr, "blosc", 4096)
    C.device_precondition(torch.from_numpy(arr.view(np.uint8)), block=4096)
    assert len(calls) == 1          # itemsize 1: nothing to shuffle


def test_device_minmax_ignores_nan_like_jax():
    arr = np.array([np.nan, 3.0, -2.0, np.inf, np.nan], np.float32)
    _, ts = C.device_array_payload(torch.from_numpy(arr), "blosc")
    _, js = JC.device_array_payload(jnp.asarray(arr), "blosc")
    assert (ts.vmin, ts.vmax) == (js.vmin, js.vmax) == (-2.0, np.inf)
    key = torch.tensor([7, 2**32 - 1], dtype=torch.uint32)
    _, ks = C.device_array_payload(key, "blosc")
    assert (ks.vmin, ks.vmax) == (7.0, float(2**32 - 1))


def test_async_series_snapshots_tensors_at_flush(tmpdir_path):
    t = torch.arange(1000, dtype=torch.float32)
    expect = t.numpy().copy()
    s = Series(tmpdir_path / "a.bp4", "w", n_ranks=2, async_io=True,
               engine_config=EngineConfig(aggregators=2, codec="blosc",
                                          device_compress=True))
    rc = s.iterations[1].meshes["t"][""]
    rc.reset_dataset(np.float32, (1000,))
    rc.store_chunk(t[:500], offset=(0,), rank=0)
    rc.store_chunk(t[500:], offset=(500,), rank=1)
    s.flush()
    t.add_(1000.0)                 # the producer reuses its buffer at once
    s.close()
    with BpReader(tmpdir_path / "a.bp4") as r:
        np.testing.assert_array_equal(r.read_var(1, "/data/1/meshes/t"),
                                      expect)


def test_parallel_io_is_not_ported_yet(tmpdir_path):
    """The parallel write plane is ported now: `parallel_io=W` writes
    through W writer processes, and a bad transport still fails the same
    way in both packages."""
    from repro_torch.core.parallel_engine import ParallelBpWriter
    arr = np.arange(64, dtype=np.float32)
    s = Series(tmpdir_path / "p.bp4", "w", n_ranks=2, parallel_io=2,
               transport="pickle",
               engine_config=EngineConfig(aggregators=2, codec="blosc"))
    rc = s.iterations[0].meshes["a"][""]
    rc.reset_dataset(arr.dtype, arr.shape)
    rc.store_chunk(torch.from_numpy(arr[:32].copy()), offset=(0,), rank=0)
    rc.store_chunk(arr[32:], offset=(32,), rank=1)
    s.flush()
    assert isinstance(s._writer, ParallelBpWriter) and s._writer.m == 2
    s.close()
    with JBpReader(tmpdir_path / "p.bp4") as r:
        np.testing.assert_array_equal(r.read_var(0, "/data/0/meshes/a"), arr)
    for series_cls in (Series, JSeries):
        with pytest.raises(ValueError, match="transport"):
            series_cls(tmpdir_path / "q.bp4", "w", transport="tcp")
