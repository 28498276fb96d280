"""The port's series tools (`repro_torch.tools`: jbpls, jbpfsck,
jbprepack, jbpstat, jbpdxt) and `repro_torch.examples.io_tuning`, against
the JAX package's.

Each case of `tests/test_tools_maintenance.py`, the jbpls cases of
`tests/test_insitu.py` and the jbpdxt CLI cases of `tests/test_dxt.py`
runs here on the port's modules; jbpstat gets three cases of its own. The
parity cases run both packages' tools over one series, written by either
package: their `--json` documents are equal, a `--repair` leaves the same
bytes, a repack reads back the same under both readers, and the
io_tuning sweep writes the same bytes."""
import importlib.util
import json
import pathlib
import shutil
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from _propcheck import given, settings, strategies as st  # noqa: E402

from repro_torch.core.bp_engine import (IDX_SIZE, BpReader,  # noqa: E402
                                        BpWriter, EngineConfig)
from repro_torch.core.darshan import MONITOR  # noqa: E402
from repro_torch.core.dxt import TRACER  # noqa: E402
from repro_torch.core.metrics import (METRICS, load_journal,  # noqa: E402
                                      summarize_cell)
from repro_torch.tools import (jbpdxt, jbpfsck, jbpls, jbprepack,  # noqa: E402
                               jbpstat)
from repro_torch.tools._runner import (EXIT_ISSUES, EXIT_OK,  # noqa: E402
                                       EXIT_USAGE)
from repro_torch.tools.jbpdxt import main as jbpdxt_main  # noqa: E402
from repro_torch.tools.jbprepack import (repack,  # noqa: E402
                                         verify_equivalent)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_port_singletons():
    """The port's MONITOR, METRICS and TRACER are process-wide and apart
    from the JAX package's (which `conftest.py` resets)."""
    MONITOR.reset()
    METRICS.reset()
    yield
    if TRACER.enabled:
        TRACER.disable()
        TRACER.reset()
    if METRICS.enabled:
        METRICS.disable()
    METRICS.reset()
    MONITOR.reset()


def _subfile_reads() -> float:
    """Total read ops+bytes recorded against any data.* subfile."""
    files = MONITOR.report()["files"]
    return sum(c.get("POSIX_READS", 0) + c.get("POSIX_BYTES_READ", 0)
               for p, c in files.items() if "data." in p)


# ============================================ tests/test_tools_maintenance.py
def _write_series(path, *, n_ranks=8, aggregators=4, codec="none", steps=3,
                  seed=7, with_scalar=True):
    cfg = EngineConfig(aggregators=aggregators, codec=codec, workers=3)
    w = BpWriter(path, n_ranks, cfg)
    rng = np.random.default_rng(seed)
    for s in range(steps):
        w.begin_step(s)
        w.set_attribute(f"/data/{s}/time", float(s) * 0.5)
        g = rng.normal(size=(n_ranks * 8, 3)).astype(np.float32)
        for r in range(n_ranks):
            w.put("mesh/rho", g[r * 8:(r + 1) * 8], global_shape=g.shape,
                  offset=(r * 8, 0), rank=r)
        ints = (rng.integers(0, 1000, size=n_ranks * 4)
                .astype(np.int64))
        for r in range(n_ranks):
            w.put("particles/id", ints[r * 4:(r + 1) * 4],
                  global_shape=ints.shape, offset=(r * 4,), rank=r)
        if with_scalar:
            w.put("scalar/t", np.array([s], np.int64), global_shape=(1,),
                  offset=(0,), rank=0)
        w.end_step()
    w.close()


def _chunk_table(reader, step, name):
    """Comparable chunk-structure view: the repack contract preserves
    (rank, offset, extent, vmin, vmax) — NOT agg/foff/nbytes, which the
    new aggregation/codec legitimately changes."""
    return sorted((c.rank, c.offset, c.extent, c.vmin, c.vmax)
                  for c in reader.iter_chunks(step, name))


# ------------------------------------------------------------ repack parity
@settings(max_examples=8, deadline=None)
@given(w_dst=st.sampled_from([1, 2, 3, 6]),
       codec=st.sampled_from(["none", "blosc"]),
       parallel=st.sampled_from([0, 3]))
def test_repack_reaggregation_parity(w_dst, codec, parallel):
    """Property: repack W=4 -> W' preserves every variable bit-exactly —
    data (compressed chunks included), per-chunk min/max metadata, chunk
    (rank, offset, extent) structure and per-step attributes.

    (Manages its own temp dir: real-hypothesis health checks forbid
    function-scoped fixtures under @given.)"""
    import pathlib
    import shutil
    import tempfile
    root = pathlib.Path(tempfile.mkdtemp(prefix="repro-repack-"))
    try:
        src = root / "src.bp4"
        dst = root / "dst.bp4"
        _write_series(src, aggregators=4, codec="blosc")
        repack(src, dst, n_writers=w_dst, codec=codec, parallel=parallel)
        n = verify_equivalent(src, dst)
        assert n == 3 * 3                # 3 steps x 3 vars, all bit-equal
        with BpReader(src) as a, BpReader(dst) as b:
            assert a.valid_steps() == b.valid_steps()
            for s in a.valid_steps():
                assert a.attributes(s) == b.attributes(s)
                for name in a.var_names(s):
                    assert _chunk_table(a, s, name) == \
                        _chunk_table(b, s, name)
                    # min/max answered from metadata must agree too
                    assert a.var_minmax(s, name) == b.var_minmax(s, name)
            # the output really is W' subfiles (8 source ranks cover all)
            aggs = {c.agg for s in b.valid_steps()
                    for c in b.iter_chunks(s, "mesh/rho")}
            assert aggs == set(range(w_dst))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_repack_recompress_changes_stored_not_read(tmpdir_path):
    # smooth (cumsum) floats — compressible, unlike the noise series
    w = BpWriter(tmpdir_path / "s.bp4", 4, EngineConfig(aggregators=2))
    rng = np.random.default_rng(3)
    g = np.cumsum(rng.normal(scale=1e-3, size=4 * 4096)
                  ).astype(np.float32)
    w.begin_step(0)
    for r in range(4):
        w.put("mesh/rho", g[r * 4096:(r + 1) * 4096],
              global_shape=g.shape, offset=(r * 4096,), rank=r)
    w.end_step()
    w.close()
    repack(tmpdir_path / "s.bp4", tmpdir_path / "z.bp4", n_writers=2,
           codec="blosc")
    verify_equivalent(tmpdir_path / "s.bp4", tmpdir_path / "z.bp4")
    with BpReader(tmpdir_path / "s.bp4") as a, \
            BpReader(tmpdir_path / "z.bp4") as b:
        raw_a, stored_a = a.var_nbytes(0, "mesh/rho")
        raw_b, stored_b = b.var_nbytes(0, "mesh/rho")
        assert raw_a == raw_b
        assert stored_b < stored_a       # smooth floats compress


def test_repack_drops_torn_steps(tmpdir_path):
    """Repack replays only committed steps — repacking a crashed series
    is also its repair."""
    _write_series(tmpdir_path / "s.bp4", steps=3)
    raw = (tmpdir_path / "s.bp4" / "md.idx").read_bytes()
    (tmpdir_path / "s.bp4" / "md.idx").write_bytes(raw[:2 * IDX_SIZE + 7])
    repack(tmpdir_path / "s.bp4", tmpdir_path / "r.bp4", n_writers=1)
    with BpReader(tmpdir_path / "r.bp4") as b:
        assert b.valid_steps() == [0, 1]


def test_repack_cli_verify_and_exit_codes(tmpdir_path, capsys):
    _write_series(tmpdir_path / "s.bp4", aggregators=2)
    rc = jbprepack.main([str(tmpdir_path / "s.bp4"),
                         str(tmpdir_path / "out.bp4"), "-w", "1",
                         "--parallel", "2", "--verify", "--io-report"])
    assert rc == EXIT_OK
    out = capsys.readouterr()
    assert "bit-identical" in out.out
    assert "POSIX_BYTES_READ" in out.err       # --io-report went to stderr
    # refusing to clobber without --force
    assert jbprepack.main([str(tmpdir_path / "s.bp4"),
                           str(tmpdir_path / "out.bp4"), "-w", "1"]) \
        == EXIT_USAGE
    assert jbprepack.main([str(tmpdir_path / "s.bp4"),
                           str(tmpdir_path / "out.bp4"), "-w", "2",
                           "--force"]) == EXIT_OK
    # not a series
    assert jbprepack.main([str(tmpdir_path / "nope"),
                           str(tmpdir_path / "x.bp4"), "-w", "1"]) \
        == EXIT_USAGE


def test_repack_striped_output_roundtrip(tmpdir_path):
    _write_series(tmpdir_path / "s.bp4", aggregators=2, steps=2)
    rc = jbprepack.main([str(tmpdir_path / "s.bp4"),
                         str(tmpdir_path / "st.bp4"), "-w", "2",
                         "--stripe", "2x256", "--verify"])
    assert rc == EXIT_OK
    assert sorted(p.name for p in
                  (tmpdir_path / "st.bp4").glob("ost*/data.*.obj"))


# ------------------------------------------------------------------- jbpfsck
def test_fsck_clean_series(tmpdir_path, capsys):
    _write_series(tmpdir_path / "s.bp4")
    assert jbpfsck.main([str(tmpdir_path / "s.bp4")]) == EXIT_OK
    assert "clean" in capsys.readouterr().out
    assert jbpfsck.main([str(tmpdir_path / "nope")]) == EXIT_USAGE


def test_fsck_torn_idx_tail_report_and_repair(tmpdir_path):
    _write_series(tmpdir_path / "s.bp4", steps=3)
    p = tmpdir_path / "s.bp4" / "md.idx"
    p.write_bytes(p.read_bytes()[:-13])          # crash during the seal
    report = jbpfsck.scan(tmpdir_path / "s.bp4")
    kinds = [i["kind"] for i in report["issues"]]
    assert "torn-idx-tail" in kinds
    assert report["committed_steps"] == [0, 1]
    assert jbpfsck.main([str(tmpdir_path / "s.bp4")]) == EXIT_ISSUES
    assert jbpfsck.main([str(tmpdir_path / "s.bp4"), "--repair"]) == EXIT_OK
    # repaired: reader and fsck agree on the resealed prefix
    assert jbpfsck.scan(tmpdir_path / "s.bp4")["issues"] == []
    with BpReader(tmpdir_path / "s.bp4") as r:
        assert r.valid_steps() == [0, 1]
        assert np.isfinite(r.read_var(1, "mesh/rho")).all()


def test_fsck_corrupt_md0_blob_truncates_to_prefix(tmpdir_path):
    _write_series(tmpdir_path / "s.bp4", steps=3)
    report = jbpfsck.scan(tmpdir_path / "s.bp4")
    # corrupt step 1's md.0 blob: steps 1 AND 2 fall off the consistent
    # prefix (reseal-to-last-consistent-step semantics)
    md = tmpdir_path / "s.bp4" / "md.0"
    raw = bytearray(md.read_bytes())
    off = report["_records"][1][1]
    raw[off + 5] ^= 0xFF
    md.write_bytes(bytes(raw))
    report = jbpfsck.scan(tmpdir_path / "s.bp4")
    assert [i["kind"] for i in report["issues"]] == ["torn-step"]
    assert report["committed_steps"] == [0, 2]
    assert report["consistent_prefix_steps"] == [0]
    jbpfsck.repair(tmpdir_path / "s.bp4", report)
    with BpReader(tmpdir_path / "s.bp4") as r:
        assert r.valid_steps() == [0]


def test_fsck_truncated_subfile_detected_and_repaired(tmpdir_path):
    """A subfile shorter than the chunk table's extents is metadata that
    validates but payload that is gone — fsck must catch it from stat
    alone and reseal to the consistent prefix."""
    _write_series(tmpdir_path / "s.bp4", steps=3, aggregators=2)
    import os
    data1 = tmpdir_path / "s.bp4" / "data.1"
    sizes = jbpfsck.scan(tmpdir_path / "s.bp4")["_max_end"]
    # keep step 0's extent, cut everything after
    per_step = sizes[1] // 3
    os.truncate(data1, per_step)
    report = jbpfsck.scan(tmpdir_path / "s.bp4")
    kinds = {i["kind"] for i in report["issues"]}
    assert kinds == {"orphaned-extent"}
    assert report["consistent_prefix_steps"] == [0]
    jbpfsck.repair(tmpdir_path / "s.bp4", report, trim=True)
    report2 = jbpfsck.scan(tmpdir_path / "s.bp4")
    assert report2["issues"] == []
    with BpReader(tmpdir_path / "s.bp4") as r:
        assert r.valid_steps() == [0]
        assert np.isfinite(r.read_var(0, "mesh/rho")).all()


def test_fsck_parallel_series_shards_and_orphan_prepare(tmpdir_path):
    """A coordinator crash between prepare and commit leaves sealed shard
    records with no md.idx commit — fsck reports the orphaned prepare as a
    NOTE (dead weight, not damage) and a torn shard tail as an ISSUE."""
    from repro_torch.core.parallel_engine import ParallelBpWriter, shard_path
    w = ParallelBpWriter(tmpdir_path / "p.bp4", 4, EngineConfig(),
                         n_writers=2)
    w.begin_step(0)
    w.put("v", np.arange(8, dtype=np.float32), global_shape=(8,),
          offset=(0,), rank=0)
    w.end_step()
    w._crash_after_prepare = True
    w.begin_step(1)
    w.put("v", np.full(8, 9, np.float32), global_shape=(8,), offset=(0,),
          rank=0)
    with pytest.raises(RuntimeError, match="simulated"):
        w.end_step()
    w._crash_after_prepare = False
    w.close()
    report = jbpfsck.scan(tmpdir_path / "p.bp4")
    assert report["issues"] == []        # orphaned prepare is NOT damage
    assert any(n["kind"] == "orphaned-prepare" and n["steps"] == [1]
               for n in report["notes"])
    # now tear a shard tail: that IS damage (crash mid-prepare)
    sp = shard_path(tmpdir_path / "p.bp4", 0)
    sp.write_bytes(sp.read_bytes()[:-3])
    report = jbpfsck.scan(tmpdir_path / "p.bp4")
    assert any(i["kind"] == "torn-shard-tail" for i in report["issues"])
    jbpfsck.repair(tmpdir_path / "p.bp4", report)
    assert jbpfsck.scan(tmpdir_path / "p.bp4")["issues"] == []


def test_fsck_json_output(tmpdir_path, capsys):
    _write_series(tmpdir_path / "s.bp4", steps=2)
    assert jbpfsck.main([str(tmpdir_path / "s.bp4"), "--json"]) == EXIT_OK
    doc = json.loads(capsys.readouterr().out)
    assert doc["committed_steps"] == [0, 1]
    assert doc["issues"] == [] and "repaired" in doc
    assert "_records" not in doc         # internal fields stay internal


# ------------------------------------------------------------ shared runner
def test_jbpls_shares_runner_conventions(tmpdir_path, capsys):
    _write_series(tmpdir_path / "s.bp4", steps=2)
    assert jbpls.main([str(tmpdir_path / "s.bp4"), "-l", "--parallel", "2",
                       "--dump", "scalar/t", "--io-report"]) == EXIT_OK
    out = capsys.readouterr()
    assert "scalar/t" in out.out
    assert "POSIX_READS" in out.err
    assert jbpls.main([str(tmpdir_path / "nope")]) == EXIT_USAGE



# ==================================== jbpls cases of tests/test_insitu.py
# ------------------------------------------------- metadata query layer
def _write_x_series(path, *, n_ranks=8, aggregators=3, codec="blosc", steps=2,
                  n=128):
    cfg = EngineConfig(aggregators=aggregators, codec=codec, workers=3)
    w = BpWriter(path, n_ranks, cfg)
    rng = np.random.default_rng(7)
    truth = {}
    per = n // n_ranks
    for s in range(steps):
        w.begin_step(s)
        g = np.cumsum(rng.normal(size=(n,))).astype(np.float32)
        truth[s] = g
        for r in range(n_ranks):
            w.put("var/x", g[r * per:(r + 1) * per], global_shape=(n,),
                  offset=(r * per,), rank=r)
        w.end_step()
    w.close()
    return truth


# ----------------------------------------------------------------- jbpls
def test_jbpls_metadata_only_100_steps(tmpdir_path, capsys):
    """Acceptance: list a >=100-step series with ZERO data.* reads."""
    n_steps = 120
    _write_x_series(tmpdir_path / "big.bp4", n_ranks=4, steps=n_steps, n=64)
    MONITOR.reset()
    rc = jbpls.main([str(tmpdir_path / "big.bp4"), "-l", "-s", "-L", "-A"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"steps: {n_steps} (0..{n_steps - 1})" in out
    assert "var/x" in out and "min/max" in out
    assert _subfile_reads() == 0, \
        "jbpls touched a data.* subfile — the O(metadata) guarantee broke"


def test_jbpls_dump_reads_payload(tmpdir_path, capsys):
    truth = _write_x_series(tmpdir_path / "s.bp4")
    MONITOR.reset()
    rc = jbpls.main([str(tmpdir_path / "s.bp4"), "--dump", "var/x",
                     "--step", "1"])
    assert rc == 0
    assert _subfile_reads() > 0               # --dump is the documented exception
    assert f"{truth[1][0]:.6g}"[:6] in capsys.readouterr().out


def test_jbpls_json_and_filters(tmpdir_path, capsys):
    import json
    _write_x_series(tmpdir_path / "s.bp4", steps=3)
    rc = jbpls.main([str(tmpdir_path / "s.bp4"), "--json", "--var", "var"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["variables"]["var/x"]["steps"] == [0, 1, 2]
    assert doc["minmax"]["var/x"] is not None


def test_jbpls_not_a_series(tmpdir_path, capsys):
    assert jbpls.main([str(tmpdir_path)]) == 2
    assert "no md.idx" in capsys.readouterr().err


def test_jbpls_minmax_spans_all_steps(tmpdir_path):
    """The listed range is the whole series', not the last step's."""
    path = tmpdir_path / "s.bp4"
    w = BpWriter(path, 1, EngineConfig())
    for s, (lo, hi) in enumerate([(-9.0, 9.0), (-1.0, 1.0)]):
        w.begin_step(s)
        w.put("x", np.linspace(lo, hi, 16, dtype=np.float32),
              global_shape=(16,), offset=(0,), rank=0)
        w.end_step()
    w.close()
    sv = jbpls.survey(BpReader(path))
    assert sv["minmax"]["x"] == (-9.0, 9.0)   # extrema live in step 0


def test_chunk_stats_nan_safe_and_json_strict(tmpdir_path, capsys):
    """NaN/inf blocks never leak NaN tokens into md.0 or jbpls --json."""
    import json
    path = tmpdir_path / "s.bp4"
    w = BpWriter(path, 1, EngineConfig())
    w.begin_step(0)
    w.put("mixed", np.array([np.nan, 1.0, np.inf, -2.0], np.float32),
          global_shape=(4,), offset=(0,), rank=0)
    w.put("allnan", np.full(4, np.nan, np.float32),
          global_shape=(4,), offset=(0,), rank=0)
    w.end_step()
    w.close()
    r = BpReader(path)
    assert r.var_minmax(0, "mixed") == (-2.0, 1.0)   # finite values only
    assert r.var_minmax(0, "allnan") is None
    assert jbpls.main([str(path), "--json"]) == 0
    strict = json.loads(capsys.readouterr().out,
                        parse_constant=lambda c: (_ for _ in ()).throw(
                            ValueError(f"non-strict token {c}")))
    assert strict["minmax"]["allnan"] is None


def test_jbpls_bad_step_and_dump_exit_cleanly(tmpdir_path, capsys):
    _write_x_series(tmpdir_path / "s.bp4", steps=2)
    assert jbpls.main([str(tmpdir_path / "s.bp4"), "--step", "99"]) == 1
    assert "no valid step 99" in capsys.readouterr().err
    assert jbpls.main([str(tmpdir_path / "s.bp4"), "--dump", "nope"]) == 1
    assert "no variable 'nope'" in capsys.readouterr().err


def test_jbpls_var_filter_is_consistent(tmpdir_path):
    """--var restricts per-step totals and layout too, not just the
    variables table."""
    path = tmpdir_path / "s.bp4"
    w = BpWriter(path, 1, EngineConfig())
    w.begin_step(0)
    w.put("density/e", np.zeros(8, np.float32), global_shape=(8,),
          offset=(0,), rank=0)
    w.put("vdist/e", np.zeros(32, np.float32), global_shape=(32,),
          offset=(0,), rank=0)
    w.end_step()
    w.close()
    sv = jbpls.survey(BpReader(path), var_filter="density")
    assert list(sv["variables"]) == ["density/e"]
    assert sv["per_step"][0]["n_vars"] == 1
    var_stored = sv["variables"]["density/e"]["stored"]
    assert sv["per_step"][0]["stored"] == var_stored
    assert sum(d["bytes"] for d in sv["layout"].values()) == var_stored



# ==================================== jbpdxt CLI cases of tests/test_dxt.py
# ------------------------------------------------------------------ jbpdxt CLI
def test_jbpdxt_cli_on_traced_series(tmpdir_path, capsys):
    TRACER.enable()
    p = tmpdir_path / "series"
    with_profiling = EngineConfig(profiling=True)
    w = BpWriter(p, n_ranks=2, cfg=with_profiling)
    for s in range(2):
        w.begin_step(s)
        for r in range(2):
            w.put("rho", np.ones((32,)) * r, global_shape=(64,),
                  offset=(r * 32,), rank=r)
        w.end_step()
    w.close()
    assert (p / "dxt.json").exists()

    chrome = tmpdir_path / "trace.json"
    dxt_txt = tmpdir_path / "trace.txt"
    rc = jbpdxt_main([str(p), "--chrome", str(chrome), "--dxt", str(dxt_txt),
                      "--bins", "5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "timeline summary" in out
    assert "straggler" in out
    assert "bandwidth over time" in out
    ch = json.loads(chrome.read_text())
    assert any(e["ph"] == "X" for e in ch["traceEvents"])
    assert "X_POSIX" in dxt_txt.read_text()

    # --json agrees with the darshan counter for the subfile
    rc = jbpdxt_main([str(p), "--json"])
    assert rc == 0
    summ = json.loads(capsys.readouterr().out)
    files = MONITOR.report()["files"]
    sub = str(p / "data.0")
    assert summ["files"][sub]["bytes_written"] == \
        files[sub]["POSIX_BYTES_WRITTEN"]


def test_jbpdxt_cli_no_trace_is_usage_error(tmpdir_path, capsys):
    assert jbpdxt_main([str(tmpdir_path)]) == 2
    assert "no trace found" in capsys.readouterr().err



# ============================================================== jbpstat
def _journal_series(path, *, writer=BpWriter, cfg=EngineConfig, metrics=None,
                    steps=3, seed=3):
    """A blosc series with its metrics journal: the engine writes
    metrics.jsonl only while the metrics plane is on and `profiling` is
    (its default)."""
    metrics = metrics or METRICS
    metrics.enable()
    try:
        w = writer(path, 4, cfg(aggregators=2, workers=2, codec="blosc"))
        rng = np.random.default_rng(seed)
        for s in range(steps):
            w.begin_step(s)
            g = rng.normal(size=(64, 4)).astype(np.float32)
            for r in range(4):
                w.put("var/x", g[r * 16:(r + 1) * 16], global_shape=g.shape,
                      offset=(r * 16, 0), rank=r)
            w.end_step()
        w.close()
    finally:
        metrics.disable()


def test_jbpstat_json_equal_between_packages(tmpdir_path, capsys):
    from repro.tools import jbpstat as ref_jbpstat
    _journal_series(tmpdir_path / "s.bp4")
    docs = []
    for tool in (jbpstat, ref_jbpstat):
        assert tool.main([str(tmpdir_path / "s.bp4"), "--json",
                          "--per-worker"]) == EXIT_OK
        docs.append(json.loads(capsys.readouterr().out))
    assert docs[0] == docs[1]
    assert docs[0]["frames"] == 4 and len(docs[0]["steps"]) == 3


def _slower(frames: list, shift: int) -> list:
    """The same journal with every latency 2**shift times slower: each
    log2 latency bucket's count moved `shift` buckets up."""
    out = json.loads(json.dumps(frames))
    for fr in out:
        for cells in [fr.get("hists", {})] + list(fr.get("workers",
                                                         {}).values()):
            for cell in cells.values():
                lat = cell["lat"]
                cell["lat"] = [0] * shift + lat[:len(lat) - shift]
                cell["lat"][-1] += sum(lat[len(lat) - shift:])
    return out


def test_jbpstat_diff_exits_1_on_a_regressed_p99(tmpdir_path, capsys):
    _journal_series(tmpdir_path / "a.bp4")
    frames = load_journal(tmpdir_path / "a.bp4")
    b = tmpdir_path / "b.jsonl"
    b.write_text("".join(json.dumps(fr) + "\n" for fr in _slower(frames, 3)))
    a = str(tmpdir_path / "a.bp4")
    assert jbpstat.main(["--diff", a, a]) == EXIT_OK
    assert "REGRESSION" not in capsys.readouterr().out
    assert jbpstat.main(["--diff", a, str(b), "--json"]) == EXIT_ISSUES
    doc = json.loads(capsys.readouterr().out)
    assert any(row.get("regression") for row in doc["ops"])
    assert jbpstat.main(["--diff", str(b), a]) == EXIT_OK   # faster: fine
    assert jbpstat.main(["--diff", a, str(tmpdir_path / "nope")]) \
        == EXIT_USAGE


def test_jbpstat_percentiles_equal_the_live_registry(tmpdir_path, capsys):
    """The claim of tests/test_metrics.py's parity case, through the CLI:
    the percentiles jbpstat prints from the journal are the live
    registry's for the same run."""
    _journal_series(tmpdir_path / "s.bp4")
    live = {ck: summarize_cell(c) for ck, c in METRICS.merged().items()}
    assert jbpstat.main([str(tmpdir_path / "s.bp4"), "--json"]) == EXIT_OK
    ops = json.loads(capsys.readouterr().out)["ops"]
    assert set(ops) == set(live)
    for ck, s in ops.items():
        for q in ("count", "p50_s", "p95_s", "p99_s", "max_s"):
            assert s[q] == live[ck][q], (ck, q)


# ============================================== parity with the JAX package
def _packages() -> dict:
    import repro.core.bp_engine as jbp
    import repro.core.darshan as jdarshan
    import repro.core.dxt as jdxt
    import repro.core.metrics as jmetrics
    from repro.tools import jbpdxt as jjbpdxt
    from repro.tools import jbpfsck as jjbpfsck
    from repro.tools import jbpls as jjbpls
    from repro.tools import jbprepack as jjbprepack
    from repro.tools import jbpstat as jjbpstat
    ns = types.SimpleNamespace
    return {
        "port": ns(BpWriter=BpWriter, BpReader=BpReader,
                   EngineConfig=EngineConfig, METRICS=METRICS,
                   TRACER=TRACER, MONITOR=MONITOR,
                   tools={"jbpls": jbpls, "jbpfsck": jbpfsck,
                          "jbpstat": jbpstat, "jbpdxt": jbpdxt,
                          "jbprepack": jbprepack}),
        "jax": ns(BpWriter=jbp.BpWriter, BpReader=jbp.BpReader,
                  EngineConfig=jbp.EngineConfig, METRICS=jmetrics.METRICS,
                  TRACER=jdxt.TRACER, MONITOR=jdarshan.MONITOR,
                  tools={"jbpls": jjbpls, "jbpfsck": jjbpfsck,
                         "jbpstat": jjbpstat, "jbpdxt": jjbpdxt,
                         "jbprepack": jjbprepack})}


def _traced_series(pkg, path):
    """A blosc series with its metrics journal and DXT trace, written by
    one package's engine."""
    pkg.TRACER.enable()
    try:
        _journal_series(path, writer=pkg.BpWriter, cfg=pkg.EngineConfig,
                        metrics=pkg.METRICS, seed=11)
    finally:
        pkg.TRACER.disable()
        pkg.TRACER.reset()
        pkg.METRICS.reset()


#: the `--json` calls compared, and the fields each document drops: none.
#: Both tools read the same files, and every time in their documents is
#: one the series stores (md.idx's t_ns, the journal's frame stamps, the
#: trace's event times), so no wall-clock or mtime field differs.
TOOL_JSON = {"jbpls": (["-l", "--json"], ()),
             "jbpfsck": (["--deep", "--json"], ()),
             "jbpstat": (["--json", "--per-worker"], ()),
             "jbpdxt": (["--json"], ())}


@pytest.mark.parametrize("tool", sorted(TOOL_JSON))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tool_json_equal_between_packages(tmpdir_path, capsys, writer, tool):
    pkgs = _packages()
    series = tmpdir_path / "s.bp4"
    _traced_series(pkgs[writer], series)
    args, dropped = TOOL_JSON[tool]
    docs = []
    for name in ("port", "jax"):
        assert pkgs[name].tools[tool].main([str(series)] + args) == EXIT_OK
        doc = json.loads(capsys.readouterr().out)
        for field in dropped:
            doc.pop(field)
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]                      # a real document came back


def _tree_bytes(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("damage", ["torn-idx-tail", "truncated-subfile"])
def test_fsck_repair_of_a_torn_port_series_reads_equal_in_both_packages(
        tmpdir_path, damage):
    pkgs = _packages()
    src = tmpdir_path / "s.bp4"
    _write_series(src, steps=3, aggregators=2, codec="blosc")
    with BpReader(src) as truth:
        want = {(s, n): truth.read_var(s, n) for s in truth.valid_steps()
                for n in truth.var_names(s)}
    if damage == "torn-idx-tail":
        p = src / "md.idx"
        p.write_bytes(p.read_bytes()[:-13])
        kept = [0, 1]
    else:
        # cut data.1 just past step 0's last chunk in it
        step0 = jbpfsck.scan(src)["_records"][0][5]
        end = max(ch["foff"] + ch["nbytes"]
                  for var in step0["vars"].values() for ch in var["chunks"]
                  if ch["agg"] == 1)
        import os
        os.truncate(src / "data.1", end + 1)
        kept = [0]
    want = {k: v for k, v in want.items() if k[0] in kept}
    copies = {}
    for name in ("port", "jax"):
        copies[name] = tmpdir_path / f"{name}.bp4"
        shutil.copytree(src, copies[name])
        assert pkgs[name].tools["jbpfsck"].main(
            [str(copies[name]), "--repair", "--trim"]) == EXIT_OK
    assert _tree_bytes(copies["port"]) == _tree_bytes(copies["jax"])
    for name in ("port", "jax"):
        with pkgs[name].BpReader(copies["port"]) as r:
            assert r.valid_steps() == kept
            for (s, n), arr in want.items():
                got = r.read_var(s, n)
                assert got.dtype == arr.dtype and got.tobytes() == \
                    arr.tobytes(), (name, s, n)


@pytest.mark.parametrize("w_dst", [1, 16])
def test_repack_byte_equivalent_under_both_readers(tmpdir_path, w_dst):
    """A W = 4 series of 16 ranks repacked to W' by each package: the
    same payload and metadata bytes (md.idx differs in its t_ns stamps
    and profiling.json in its timings, nothing else), and every variable
    reads back bit-equal to the source under both readers."""
    pkgs = _packages()
    src = tmpdir_path / "s.bp4"
    _write_series(src, n_ranks=16, aggregators=4, codec="blosc")
    outs = {}
    for name in ("port", "jax"):
        outs[name] = tmpdir_path / f"{name}.bp4"
        rp = pkgs[name].tools["jbprepack"]
        rp.repack(src, outs[name], n_writers=w_dst)
        assert rp.verify_equivalent(src, outs[name]) == 3 * 3
    a, b = _tree_bytes(outs["port"]), _tree_bytes(outs["jax"])
    assert set(a) == set(b)
    assert sum(n.startswith("data.") for n in a) == w_dst
    for n in a:
        if n not in ("md.idx", "profiling.json"):
            assert a[n] == b[n], n
    with BpReader(src) as truth:
        for name in ("port", "jax"):
            for out in outs.values():
                with pkgs[name].BpReader(out) as r:
                    assert r.valid_steps() == truth.valid_steps()
                    for s in truth.valid_steps():
                        for v in truth.var_names(s):
                            assert r.read_var(s, v).tobytes() == \
                                truth.read_var(s, v).tobytes()


# ============================================================ io_tuning
def _io_tuning_modules():
    from repro_torch.examples import io_tuning
    spec = importlib.util.spec_from_file_location(
        "reference_io_tuning", REPO / "examples" / "io_tuning.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return io_tuning, ref


def _sweep(module, monkeypatch) -> list:
    """The (tag, EngineConfig) pairs `main()` sweeps, in order."""
    calls = []
    monkeypatch.setattr(module, "one", lambda tag, cfg: calls.append(
        (tag, cfg)))
    module.main()
    monkeypatch.undo()
    return calls


IO_TUNING_CONFIGS = 11      # 4 aggregator counts, 3 codecs, 4 stripings


@pytest.mark.parametrize("i", range(IO_TUNING_CONFIGS))
def test_io_tuning_writes_the_same_bytes_as_the_reference(monkeypatch, i):
    """Each configuration of the sweep at 4 ranks of 16 KiB: Darshan's
    POSIX_BYTES_WRITTEN and the stored files' sizes equal between the
    packages."""
    from repro.core.darshan import MONITOR as JMONITOR
    port, ref = _io_tuning_modules()
    sweeps = [_sweep(m, monkeypatch) for m in (port, ref)]
    assert len(sweeps[0]) == len(sweeps[1]) == IO_TUNING_CONFIGS
    assert [t for t, _ in sweeps[0]] == [t for t, _ in sweeps[1]]
    got = []
    for module, monitor, sweep in ((port, MONITOR, sweeps[0]),
                                   (ref, JMONITOR, sweeps[1])):
        sizes = {}

        def rmtree(d, ignore_errors=False, _sizes=sizes):
            _sizes.update({p.relative_to(d).as_posix(): p.stat().st_size
                           for p in pathlib.Path(d).rglob("*")
                           if p.is_file()})
            shutil.rmtree(d, ignore_errors=ignore_errors)

        monkeypatch.setattr(module, "shutil",
                            types.SimpleNamespace(rmtree=rmtree))
        tag, cfg = sweep[i]
        module.one(tag, cfg, n_ranks=4, bytes_per_rank=16 * 1024)
        monkeypatch.undo()
        # profiling.json holds the run's timings, so its length is the
        # one that may differ; every other file must match byte for byte
        written = {p.split("s.bp4/", 1)[1]: c.get("POSIX_BYTES_WRITTEN", 0)
                   for p, c in monitor.report()["files"].items()
                   if "s.bp4/" in p and not p.endswith("profiling.json")}
        stored = {k: v for k, v in sizes.items()
                  if not k.endswith("profiling.json")}
        got.append((written, stored, sorted(sizes)))
    assert got[0][0] == got[1][0]
    assert sum(got[0][0].values()) > 0
    assert got[0][1] == got[1][1]
    assert got[0][2] == got[1][2]
