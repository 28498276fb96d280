"""The port's remaining host I/O planes against the JAX package's: the
Original-I/O baseline (`core/original_io.py`), SST streaming
(`core/sst_engine.py`) and in-situ reduction (`insitu/`). These are
numpy-only copies, so files, reductions and stream contents must be
identical, not close, unless a comparison says otherwise. Mirrors
`tests/test_original_io.py`, `test_darshan.py::
test_original_io_metadata_dominance`, `test_insitu.py`, the SST and
reducer cases of `test_runtime_validation.py`,
`test_extensions.py::test_sst_streaming_roundtrip` and the SST tee cases
of `test_async_engine.py`."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import original_io as joio
from repro.insitu import (FieldEnergy as JFieldEnergy, Histogram as
                          JHistogram, Moments as JMoments, PhaseSpace2D as
                          JPhaseSpace2D, ReducerSet as JReducerSet,
                          SpeciesCount as JSpeciesCount,
                          reduce_posthoc as jreduce_posthoc)
from repro.pic import simulation as jsim
from repro_torch.core.async_engine import AsyncBpWriter
from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig
from repro_torch.core.darshan import MONITOR
from repro_torch.core.original_io import read_dmp, write_dat, write_dmp
from repro_torch.core.sst_engine import SstStream, attach_consumer
from repro_torch.insitu import (FieldEnergy, Histogram, Moments,
                                PhaseSpace2D, ReducerSet, SpeciesCount,
                                assert_parity, attach_reducers,
                                reduce_posthoc)
from repro_torch.pic import simulation as sim
from repro_torch.pic.convert import state_from_numpy


@pytest.fixture(autouse=True)
def port_env():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    MONITOR.reset()
    yield
    MONITOR.reset()
    torch.set_num_threads(n)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(100,)).astype(np.float32),
            "v": rng.normal(size=(100, 3)).astype(np.float64),
            "ids": np.arange(7, dtype=np.int32),
            "empty": np.zeros((0,), np.float32)}


# ------------------------------------------------------------ Original I/O
def test_dmp_roundtrip(tmpdir_path):
    arrays = _arrays()
    p = write_dmp(tmpdir_path, 2, 50, arrays)
    assert p.name == "state_0000050_r00002.dmp"
    back = read_dmp(p)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype and back[k].shape == v.shape


@pytest.mark.parametrize("rank,step", [(0, 0), (3, 120), (15, 9999)])
def test_dat_and_dmp_bytes_identical_to_jax(tmpdir_path, rank, step):
    arrays = _arrays(rank)
    a = tmpdir_path / "port"
    b = tmpdir_path / "jax"
    pd, jd = write_dat(a, rank, step, arrays), joio.write_dat(b, rank, step,
                                                               arrays)
    pm, jm = write_dmp(a, rank, step, arrays), joio.write_dmp(b, rank, step,
                                                               arrays)
    assert pd.name == jd.name and pm.name == jm.name
    assert pd.read_bytes() == jd.read_bytes()
    assert pm.read_bytes() == jm.read_bytes()
    # each package reads the other's .dmp
    for k, v in joio.read_dmp(pm).items():
        np.testing.assert_array_equal(v, arrays[k])
    for k, v in read_dmp(jm).items():
        np.testing.assert_array_equal(v, arrays[k])


def test_dat_values_per_line_matches_jax(tmpdir_path):
    arr = {"ne": np.linspace(-1, 1, 37, dtype=np.float32)}
    for vpl in (1, 5, 8, 64):
        p = write_dat(tmpdir_path / f"p{vpl}", 1, 2, arr, values_per_line=vpl)
        j = joio.write_dat(tmpdir_path / f"j{vpl}", 1, 2, arr,
                           values_per_line=vpl)
        assert p.read_bytes() == j.read_bytes()


def test_file_count_scales_with_ranks(tmpdir_path):
    """Paper Table II: total files O(ranks); avg size O(1/ranks)."""
    arr = np.arange(4096, dtype=np.float32)
    for n_ranks in (4, 8):
        d = tmpdir_path / f"r{n_ranks}"
        for r in range(n_ranks):
            write_dat(d, r, 0, {"ne": arr[:4096 // n_ranks]})
            write_dmp(d, r, 0, {"x": arr[:4096 // n_ranks]})
        files = list(d.iterdir())
        assert len(files) == 2 * n_ranks
    s4 = sum(f.stat().st_size for f in (tmpdir_path / "r4").iterdir()) / 8
    s8 = sum(f.stat().st_size for f in (tmpdir_path / "r8").iterdir()) / 16
    assert s8 < s4          # avg file size shrinks with rank count


def test_original_io_metadata_dominance(tmpdir_path):
    """The paper's Fig 5 pathology, through the port's Darshan monitor:
    one open a file, O(ranks) files, metadata and write time both
    recorded."""
    arr = np.arange(64, dtype=np.float32)
    for r in range(16):
        write_dat(tmpdir_path, r, 0, {"ne": arr})
        write_dmp(tmpdir_path, r, 0, {"x": arr})
    rep = MONITOR.report()
    assert rep["total"]["POSIX_OPENS"] == 32
    assert MONITOR.total_files_written() == 32
    cost = MONITOR.cost_per_process()
    assert cost["meta_s"] > 0 and cost["write_s"] > 0


def test_original_io_counts_match_jax_monitor(tmpdir_path):
    """The same writes give the same Darshan op and byte counts in both
    packages' monitors (times differ)."""
    from repro.core.darshan import MONITOR as JMONITOR
    JMONITOR.reset()
    arr = np.arange(300, dtype=np.float32)
    for r in range(4):
        write_dat(tmpdir_path / "p", r, 0, {"ne": arr})
        write_dmp(tmpdir_path / "p", r, 0, {"x": arr})
        joio.write_dat(tmpdir_path / "j", r, 0, {"ne": arr})
        joio.write_dmp(tmpdir_path / "j", r, 0, {"x": arr})
    a, b = MONITOR.report()["total"], JMONITOR.report()["total"]
    for k in ("POSIX_OPENS", "POSIX_WRITES", "POSIX_BYTES_WRITTEN",
              "POSIX_FSYNCS"):
        assert a.get(k) == b.get(k), k
    JMONITOR.reset()


# ---------------------------------------------------------------- reducers
def _suites():
    port = ReducerSet([
        Moments("density/e"),
        Histogram("density/e", bins=32, range=(-4.0, 4.0)),
        Histogram("density/e", bins=16, range=(-4.0, 4.0),
                  weight_var="weight/e", name="weighted_hist"),
        PhaseSpace2D("density/e", "weight/e", bins=(8, 8),
                     range=((-4.0, 4.0), (0.0, 1.0))),
        FieldEnergy("density/e", cell_volume=0.5),
        SpeciesCount("weight/e", scale=2.0)])
    jax_ = JReducerSet([
        JMoments("density/e"),
        JHistogram("density/e", bins=32, range=(-4.0, 4.0)),
        JHistogram("density/e", bins=16, range=(-4.0, 4.0),
                   weight_var="weight/e", name="weighted_hist"),
        JPhaseSpace2D("density/e", "weight/e", bins=(8, 8),
                      range=((-4.0, 4.0), (0.0, 1.0))),
        JFieldEnergy("density/e", cell_volume=0.5),
        JSpeciesCount("weight/e", scale=2.0)])
    return port, jax_


def _produce_stream(stream, *, n_steps, n_ranks=4, n=64, seed=0):
    rng = np.random.default_rng(seed)
    truth = {}
    per = n // n_ranks
    for s in range(n_steps):
        g = rng.normal(size=(n,)).astype(np.float32)
        w = rng.uniform(size=(n,)).astype(np.float32)
        truth[s] = {"density/e": g, "weight/e": w}
        stream.begin_step(s)
        for r in range(n_ranks):
            sl = slice(r * per, (r + 1) * per)
            stream.put("density/e", g[sl], global_shape=(n,),
                       offset=(r * per,), rank=r)
            stream.put("weight/e", w[sl], global_shape=(n,),
                       offset=(r * per,), rank=r)
        stream.end_step()
    return truth


def test_moments_matches_numpy():
    r = Moments("x")
    chunks = [np.arange(10, dtype=np.float64), np.linspace(-3, 5, 7)]
    for s, a in enumerate(chunks):
        r.update(s, {"x": a})
    allv = np.concatenate(chunks)
    res = r.result()
    assert res["n"] == allv.size and res["steps"] == 2
    np.testing.assert_allclose(res["mean"], allv.mean())
    np.testing.assert_allclose(res["var"], allv.var(), rtol=1e-12)
    assert res["min"] == allv.min() and res["max"] == allv.max()


def test_histogram_matches_numpy():
    r = Histogram("x", bins=20, range=(-2.0, 2.0))
    vals = [np.random.default_rng(i).normal(size=100) for i in range(3)]
    for s, a in enumerate(vals):
        r.update(s, {"x": a})
    expect, edges = np.histogram(np.concatenate(vals), bins=20,
                                 range=(-2.0, 2.0))
    res = r.result()
    np.testing.assert_array_equal(res["counts"], expect.astype(np.float64))
    np.testing.assert_array_equal(res["edges"], edges)


def test_reducers_equal_jax_reducers_exactly():
    """The same steps through both packages' reducers give identical
    result trees (both are float64 numpy in the same order)."""
    port, jx = _suites()
    rng = np.random.default_rng(3)
    for s in range(6):
        step = {"density/e": rng.normal(size=128).astype(np.float32),
                "weight/e": rng.uniform(size=128).astype(np.float32)}
        if s == 2:
            step.pop("weight/e")          # missing vars are skipped alike
        port.update(s, step)
        jx.update(s, step)
    assert_parity(port.results(), jx.results())


def test_reducers_skip_missing_vars():
    rset, _ = _suites()
    rset.update(0, {"unrelated": np.ones(4)})
    res = rset.results()
    assert res["moments(density/e)"]["n"] == 0
    assert res["count(weight/e)"]["steps"].size == 0


def test_reducer_set_needed_vars():
    assert _suites()[0].needed_vars == {"density/e", "weight/e"}


def test_reducer_set_rejects_duplicate_names():
    with pytest.raises(ValueError, match="duplicate reducer names"):
        ReducerSet([Moments("var/x", name="m"), Moments("var/y", name="m")])


def test_assert_parity_contract():
    a = {"m": np.arange(4, dtype=np.float32)}
    assert_parity(a, {"m": np.arange(4, dtype=np.float32)})
    with pytest.raises(AssertionError, match="keys"):
        assert_parity(a, {"other": a["m"]})
    with pytest.raises(AssertionError):
        assert_parity(a, {"m": a["m"] + 1})
    b = {"m": a["m"] + 1e-4}
    assert_parity(a, b, atol=1e-3)          # parity within a lossy bound
    with pytest.raises(AssertionError, match="atol"):
        assert_parity(a, b, atol=1e-5)


def test_parity_detects_divergence():
    a = ReducerSet([Moments("x")])
    b = ReducerSet([Moments("x")])
    a.update(0, {"x": np.ones(4)})
    b.update(0, {"x": np.zeros(4)})
    with pytest.raises(AssertionError, match="moments"):
        assert_parity(a.results(), b.results())


@pytest.mark.parametrize("codec", ["none", "blosc"])
def test_parity_stream_vs_posthoc(tmpdir_path, codec):
    """A live reduction over the port's SstStream equals the post-hoc
    replay over the teed series bit for bit, and the JAX package's replay
    of the port's series equals it too."""
    path = tmpdir_path / "teed.bp4"
    tee = AsyncBpWriter(path, 4, EngineConfig(aggregators=2, codec=codec))
    stream = SstStream(queue_depth=2, tee=tee)
    live, _ = _suites()
    t = attach_reducers(stream, live)
    _produce_stream(stream, n_steps=25)
    stream.close()
    t.join(timeout=30)
    assert not t.is_alive() and t.error is None
    posthoc = reduce_posthoc(str(path), _suites()[0])
    assert_parity(live.results(), posthoc)
    assert_parity(live.results(), jreduce_posthoc(str(path), _suites()[1]))


def test_reduce_posthoc_reads_only_needed_vars(tmpdir_path):
    path = tmpdir_path / "s.bp4"
    w = BpWriter(path, 2, EngineConfig(aggregators=2))
    for s in range(3):
        w.begin_step(s)
        for name in ("wanted", "ignored"):
            for r in range(2):
                w.put(name, np.full(8, s, np.float32), global_shape=(16,),
                      offset=(r * 8,), rank=r)
        w.end_step()
    w.close()
    seen = []
    reader = BpReader(path)
    orig = reader.read_var
    reader.read_var = lambda step, name, *a, **k: (
        seen.append(name), orig(step, name, *a, **k))[1]
    res = reduce_posthoc(reader, ReducerSet([Moments("wanted")]))
    reader.close()
    assert set(seen) == {"wanted"}
    assert res["moments(wanted)"]["steps"] == 3


# ------------------------------------------------------------- SstStream
def test_sst_stream_step_protocol():
    s = SstStream()
    with pytest.raises(RuntimeError, match="outside a step"):
        s.put("v", np.zeros(2, np.float32))
    s.begin_step(0)
    with pytest.raises(RuntimeError, match="still open"):
        s.begin_step(1)


def test_sst_streaming_roundtrip():
    stream = SstStream(queue_depth=2)
    seen = {}
    t = attach_consumer(stream, lambda step, data: seen.update({step: data}))
    for s in range(3):
        stream.begin_step(s)
        stream.put("n", np.full(4, s, np.float32), global_shape=(8,),
                   offset=(0,))
        stream.put("n", np.full(4, s + 10, np.float32), global_shape=(8,),
                   offset=(4,))
        stream.end_step()
    stream.close()
    t.join(timeout=5)
    assert sorted(seen) == [0, 1, 2]
    np.testing.assert_array_equal(
        seen[2]["n"], np.concatenate([np.full(4, 2.0), np.full(4, 12.0)]))


def test_sst_close_with_full_queue_and_no_consumer():
    stream = SstStream(queue_depth=1)
    stream.begin_step(0)
    stream.put("x", np.ones(4))
    stream.end_step()
    done = threading.Event()

    def closer():
        stream.close()
        done.set()

    t = threading.Thread(target=closer, daemon=True)
    t.start()
    assert done.wait(timeout=5), "close() deadlocked on a full queue"
    got = list(stream.steps(timeout=2))
    assert len(got) == 1 and got[0][0] == 0


def test_sst_steps_timeout_ends_iterator():
    stream = SstStream(queue_depth=2)
    t0 = time.monotonic()
    assert list(stream.steps(timeout=0.3)) == []
    assert 0.2 < time.monotonic() - t0 < 2.0


def test_sst_steps_timeout_is_per_step():
    stream = SstStream(queue_depth=4)
    for s in range(3):
        stream.begin_step(s)
        stream.put("x", np.full(2, s))
        stream.end_step()
    stream.close()
    assert [s for s, _ in stream.steps(timeout=0.5)] == [0, 1, 2]


def test_sst_blocked_consumer_wakes_on_close():
    stream = SstStream(queue_depth=2)
    seen = []
    t = attach_consumer(stream, lambda s, v: seen.append(s))
    time.sleep(0.15)
    stream.begin_step(7)
    stream.put("x", np.ones(3))
    stream.end_step()
    stream.close()
    t.join(timeout=5)
    assert not t.is_alive() and seen == [7]


def test_sst_raising_consumer_does_not_wedge_producer():
    stream = SstStream(queue_depth=1)

    def bad(step, vars):
        raise ValueError("boom")

    t = attach_consumer(stream, bad)
    for s in range(5):
        stream.begin_step(s)
        stream.put("x", np.full(4, s))
        stream.end_step()
    stream.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert isinstance(t.error, ValueError)


def test_sst_tee_close_cleans_up_on_write_error(tmpdir_path):
    tee = AsyncBpWriter(tmpdir_path / "tee.bp4", 1,
                        EngineConfig(codec="no-such-codec"))
    stream = SstStream(queue_depth=2, tee=tee)
    stream.begin_step(0)
    stream.put("n", np.ones(4, np.float32), global_shape=(4,), offset=(0,))
    stream.end_step()
    with pytest.raises(ValueError, match="unknown codec"):
        stream.close()
    assert not tee._writer_thread.is_alive()


def test_tee_error_does_not_wedge_the_stream(tmpdir_path):
    tee = AsyncBpWriter(tmpdir_path / "tee.bp4", 1,
                        EngineConfig(codec="no-such-codec"))
    stream = SstStream(queue_depth=4, tee=tee)
    seen = {}
    t = attach_consumer(stream, lambda s, data: seen.update({s: data}))
    stream.begin_step(0)
    stream.put("n", np.zeros(2, np.float32), global_shape=(2,), offset=(0,))
    stream.end_step()
    with pytest.raises(ValueError, match="unknown codec"):
        tee.drain()
    stream.begin_step(1)
    stream.put("n", np.ones(2, np.float32), global_shape=(2,), offset=(0,))
    with pytest.raises(ValueError, match="unknown codec"):
        stream.end_step()
    stream.begin_step(2)
    stream.put("n", np.full(2, 2, np.float32), global_shape=(2,),
               offset=(0,))
    with pytest.raises(ValueError, match="unknown codec"):
        stream.end_step()
    stream._tee = None
    stream.close()
    t.join(timeout=5)
    assert sorted(seen) == [0, 1, 2]
    with pytest.raises(ValueError, match="unknown codec"):
        tee.close()


# ------------------------------------------------------------- PIC wiring
def _jax_flat(state):
    from repro.ckpt.checkpoint import flatten_state
    return {k: np.asarray(v) for k, v in
            flatten_state(state._asdict()).items()}


def _pic_reducers(pkg, cfg):
    M, S, F = ((Moments, SpeciesCount, FieldEnergy) if pkg == "port"
               else (JMoments, JSpeciesCount, JFieldEnergy))
    R = ReducerSet if pkg == "port" else JReducerSet
    return R([S("density/e", scale=cfg.dx, name="n_e"),
              S("density/D", scale=cfg.dx, name="n_D"),
              M("vdist/e", name="vdist_moments"),
              F("density/e", cell_volume=cfg.dx, name="e_field_energy")])


def test_pic_live_reducers_equal_jax_on_the_same_states(tmpdir_path):
    """Each chunk: both packages' states advance with JAX's draws
    replayed, then each package's `run_with_diagnostics` (0 steps, a
    stream with its reducers live on a consumer thread, and the same
    reducers inline) reduces its own state's diagnostics. The velocity
    moments are exact (the histograms are equal); the density sums within
    rtol 1e-5 (float32 deposits summed in another order)."""
    from repro.core.sst_engine import (SstStream as JSstStream)
    from repro.insitu import attach_reducers as jattach
    cfg = jsim.PicConfig(n_cells=128, capacity=2048, n_electrons=1024,
                         n_ions=1024, n_neutrals=1024, rate_R=0.5, dt=1e-2)
    jstate = jsim.init_sim(cfg, jax.random.PRNGKey(0))
    tstate = state_from_numpy(_jax_flat(jstate), "cpu")
    pstream, jstream = SstStream(queue_depth=2), JSstStream(queue_depth=2)
    plive, jlive = _pic_reducers("port", cfg), _pic_reducers("jax", cfg)
    pinline = _pic_reducers("port", cfg)
    pt, jt = attach_reducers(pstream, plive), jattach(jstream, jlive)
    C = cfg.capacity
    for _ in range(3):
        for _ in range(2):
            _, sub = jax.random.split(jstate.key)
            draws = {"u": torch.from_numpy(np.array(
                         jax.random.uniform(sub, (C,)))),
                     "kick": torch.from_numpy(np.array(jax.random.normal(
                         jax.random.fold_in(sub, 1), (C, 3))))}
            jstate = jsim.pic_step(jstate, cfg)
            tstate = sim.pic_step(tstate, cfg, draws=draws)
        sim.run_with_diagnostics(tstate, cfg, None, n_chunks=1,
                                 steps_per_chunk=0, stream=pstream,
                                 reducers=pinline)
        jsim.run_with_diagnostics(jstate, cfg, None, n_chunks=1,
                                  steps_per_chunk=0, stream=jstream)
    pstream.close()
    jstream.close()
    pt.join(timeout=10)
    jt.join(timeout=10)
    pres, jres = plive.results(), jlive.results()
    assert_parity(pres, pinline.results())
    assert_parity(pres["vdist_moments"], jres["vdist_moments"])
    assert list(pres["n_e"]["steps"]) == list(jres["n_e"]["steps"]) == \
        [2, 4, 6]
    for name in ("n_e", "n_D"):
        np.testing.assert_allclose(pres[name]["counts"], jres[name]["counts"],
                                   rtol=1e-5)
    np.testing.assert_allclose(pres["e_field_energy"]["energy"],
                               jres["e_field_energy"]["energy"], rtol=1e-5)
    assert pres["n_D"]["counts"][-1] < pres["n_D"]["counts"][0]


def test_sst_streaming_example_runs_on_the_cpu():
    from repro_torch.examples import sst_streaming
    res = sst_streaming.main(["--device", "cpu", "--scale", "4096",
                              "--chunks", "3", "--steps-per-chunk", "20"])
    assert len(res["n_e"]["steps"]) == 3
