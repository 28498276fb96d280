"""The port's I/O-plane linter (`repro_torch.analysis`,
`repro_torch.tools.jbplint`) against the JAX package's: each case of
`tests/test_jbplint.py` on the port's modules (one good/bad fixture pair
a rule, path scoping, suppressions, baselines, CLI exit codes), the gate
over `src/repro_torch`, and the two linters' findings equal over the JAX
package's tree, the port's, and fixtures that fire every rule."""
import json
import pathlib
import textwrap

import pytest

from repro_torch.analysis import analyze_paths, baseline_doc
from repro_torch.analysis.framework import PARSE_RULE
from repro_torch.tools.jbplint import main as jbplint_main

REPO = pathlib.Path(__file__).resolve().parents[1]


def _src(tmp, rel, body):
    p = tmp / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))
    return p


def _rules(res):
    return [f.rule for f in res.findings]


# ------------------------------------------------------------------ JBP001
def test_jbp001_flags_bare_assert(tmpdir_path):
    bad = _src(tmpdir_path, "core/bad.py", """\
        def check(n):
            assert n > 0, "n must be positive"
            return n
        """)
    res = analyze_paths([bad])
    assert _rules(res) == ["JBP001"]
    assert res.findings[0].symbol == "check"


def test_jbp001_good_raise_is_clean(tmpdir_path):
    good = _src(tmpdir_path, "core/good.py", """\
        def check(n):
            if n <= 0:
                raise ValueError(f"n must be positive, got {n}")
            return n
        """)
    assert analyze_paths([good]).clean


def test_jbp001_kernel_code_is_exempt(tmpdir_path):
    kern = _src(tmpdir_path, "kernels/ref.py", """\
        def ref(n):
            assert n > 0
            return n
        """)
    assert analyze_paths([kern]).clean


# ------------------------------------------------------------------ JBP002
def test_jbp002_flags_raw_io_on_data_plane(tmpdir_path):
    bad = _src(tmpdir_path, "core/bad_io.py", """\
        import os
        import pathlib

        def load(p):
            raw = open(p).read()
            fd = os.open(p, 0)
            txt = pathlib.Path(p).read_text()
            return raw, fd, txt
        """)
    res = analyze_paths([bad])
    assert _rules(res) == ["JBP002"] * 3


def test_jbp002_open_file_is_clean(tmpdir_path):
    good = _src(tmpdir_path, "core/good_io.py", """\
        from repro_torch.core.darshan import open_file

        def load(p):
            with open_file(p, "rb") as f:
                return f.read()
        """)
    assert analyze_paths([good]).clean


def test_jbp002_scoped_to_io_plane_dirs(tmpdir_path):
    # same raw open() OUTSIDE core/serve/tools — not a data-plane file
    off = _src(tmpdir_path, "insitu/elsewhere.py", """\
        def load(p):
            return open(p).read()
        """)
    assert analyze_paths([off]).clean


# ------------------------------------------------------------------ JBP003
def test_jbp003_flags_counter_literals(tmpdir_path):
    bad = _src(tmpdir_path, "core/bad_ctr.py", """\
        def bump(mon, path):
            mon.record(0, path, "POSIX_WRITES", 1.0)
            mon.record(0, path, counter="SERVICE_CACHE_HIT")
        """)
    res = analyze_paths([bad])
    assert _rules(res) == ["JBP003"] * 2


def test_jbp003_registry_constants_and_dxt_keys_clean(tmpdir_path):
    good = _src(tmpdir_path, "core/good_ctr.py", """\
        from repro_torch.core.darshan import CTR

        def bump(mon, tracer, path):
            mon.record(0, path, CTR.POSIX_WRITES, 1.0)
            tracer.record(0, path, "write", 0, 4, 0.0, 0.1)
        """)
    assert analyze_paths([good]).clean


# ------------------------------------------------------------------ JBP004
def test_jbp004_flags_blocking_under_lock(tmpdir_path):
    bad = _src(tmpdir_path, "serve/bad_lock.py", """\
        def pump(self, sock):
            with self._lock:
                return sock.recv(4096)

        def drain(self, task_q):
            with self._lock:
                return task_q.get()
        """)
    res = analyze_paths([bad])
    assert _rules(res) == ["JBP004"] * 2


def test_jbp004_timeouts_conditions_and_nested_defs_exempt(tmpdir_path):
    good = _src(tmpdir_path, "serve/good_lock.py", """\
        def drain(self, task_q):
            with self._lock:
                return task_q.get(timeout=1.0)

        def wait(self):
            with self._cond_lock:
                self._cond_lock.wait()     # Condition releases the lock

        def plan(self):
            with self._lock:
                def later(sock):           # deferred: runs OUTSIDE the lock
                    return sock.recv(4)
                self.cb = later
        """)
    assert analyze_paths([good]).clean


# ------------------------------------------------------------------ JBP005
def test_jbp005_flags_spawn_unsafe_targets(tmpdir_path):
    bad = _src(tmpdir_path, "core/bad_spawn.py", """\
        import multiprocessing as mp

        def launch(plane, task_q):
            def local():
                return 1
            p = mp.Process(target=lambda: 1)
            spawn_io_workers(plane, local)
            task_q.put(("job", lambda: 2))
            return p
        """)
    res = analyze_paths([bad])
    assert _rules(res) == ["JBP005"] * 3


def test_jbp005_module_level_target_clean(tmpdir_path):
    good = _src(tmpdir_path, "core/good_spawn.py", """\
        import multiprocessing as mp

        def worker_main(q):
            q.put("done")

        def launch(q):
            return mp.Process(target=worker_main, args=(q,))
        """)
    assert analyze_paths([good]).clean


# ------------------------------------------------------------------ JBP006
def test_jbp006_flags_wall_clock_durations(tmpdir_path):
    bad = _src(tmpdir_path, "core/bad_clock.py", """\
        import time

        def slow_op(t0, deadline):
            dt = time.time() - t0
            if time.time() > deadline:
                raise TimeoutError(f"{dt:.1f}s")
            return dt
        """)
    res = analyze_paths([bad])
    assert _rules(res) == ["JBP006"] * 2


def test_jbp006_perf_counter_and_epoch_stamps_clean(tmpdir_path):
    good = _src(tmpdir_path, "core/good_clock.py", """\
        import time

        def timed_op(run):
            t_wall = time.time()          # epoch STAMP: legal
            t0 = time.perf_counter()
            run()
            dt = time.perf_counter() - t0
            return {"t": t_wall, "dt": dt}
        """)
    assert analyze_paths([good]).clean


def test_jbp006_scoped_to_data_plane_dirs(tmpdir_path):
    off_plane = _src(tmpdir_path, "analysis/clock.py", """\
        import time

        def elapsed(t0):
            return time.time() - t0
        """)
    assert analyze_paths([off_plane]).clean


# ----------------------------------------------------------- suppressions
def test_suppression_trailing_and_preceding_comment(tmpdir_path):
    f = _src(tmpdir_path, "core/supp.py", """\
        def a(p):
            return open(p).read()   # jbplint: disable=JBP002

        def b(p):
            # sidecar of the tracer itself, see DESIGN.md
            # jbplint: disable=JBP002
            return open(p).read()

        def c(p):
            return open(p).read()   # jbplint: disable=JBP001
        """)
    res = analyze_paths([f])
    # a+b suppressed; c's directive names the WRONG rule, so it still fires
    assert _rules(res) == ["JBP002"]
    assert res.findings[0].symbol == "c"
    assert res.suppressed == 2


# --------------------------------------------------------------- baseline
def test_baseline_parks_findings_and_survives_line_drift(tmpdir_path):
    body = """\
        def check(n):
            assert n > 0, "positive"
            return n
        """
    f = _src(tmpdir_path, "core/base.py", body)
    first = analyze_paths([f])
    assert len(first.findings) == 1
    keys = frozenset(e["key"]
                     for e in baseline_doc(first.findings)["findings"])

    # unrelated edit ABOVE the finding: line number moves, key must not
    _src(tmpdir_path, "core/base.py", "# a new leading comment\n"
         + textwrap.dedent(body))
    drifted = analyze_paths([f], baseline_keys=keys)
    assert drifted.clean
    assert drifted.baselined == 1

    # a NEW finding in the same file is not covered by the old baseline
    _src(tmpdir_path, "core/base.py", textwrap.dedent(body)
         + "\ndef other(m):\n    assert m, 'm'\n")
    fresh = analyze_paths([f], baseline_keys=keys)
    assert len(fresh.findings) == 1
    assert fresh.findings[0].symbol == "other"
    assert fresh.baselined == 1


def test_syntax_error_is_a_gating_finding(tmpdir_path):
    f = _src(tmpdir_path, "core/broken.py", "def oops(:\n")
    res = analyze_paths([f])
    assert _rules(res) == [PARSE_RULE]


# -------------------------------------------------------------------- CLI
def test_cli_exit_codes(tmpdir_path, capsys):
    bad = _src(tmpdir_path, "core/cli_bad.py", "assert True, 'x'\n")
    good = _src(tmpdir_path, "core/cli_good.py", "X = 1\n")

    assert jbplint_main([]) == 2                       # no paths
    assert jbplint_main(["--rules", "JBP999", str(good)]) == 2
    assert jbplint_main([str(tmpdir_path / "nope.py")]) == 2
    assert jbplint_main([str(good)]) == 0
    assert jbplint_main([str(bad)]) == 1
    assert jbplint_main(["--rules", "JBP002", str(bad)]) == 0  # rule select
    capsys.readouterr()

    assert jbplint_main(["--json", str(bad)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["tool"] == "jbplint" and doc["clean"] is False
    assert doc["findings"][0]["rule"] == "JBP001"

    base = tmpdir_path / "base.json"
    assert jbplint_main(["--write-baseline", str(base), str(bad)]) == 0
    assert jbplint_main(["--baseline", str(base), str(bad)]) == 0
    assert jbplint_main(["--baseline", str(base), str(bad), str(good)]) == 0
    assert jbplint_main(["--list-rules"]) == 0


# ----------------------------------------------------------- tier-1 gate
def test_jbplint_clean():
    """The port's own tree lints clean under the port's linter — the
    zero-finding invariant the JAX package's gate holds for its tree."""
    assert jbplint_main([str(REPO / "src" / "repro_torch")]) == 0




# --------------------------------------------- parity with the JAX package
_EVERY_RULE = {
    "core/assert.py": "def f(n):\n    assert n, 'n'\n",
    "core/raw.py": "import os\n\ndef f(p):\n    return open(p), os.open(p, 0)\n",
    "core/ctr.py": "def f(m, p):\n    m.record(0, p, 'POSIX_WRITES', 1.0)\n",
    "serve/lock.py": ("def f(self, s):\n    with self._lock:\n"
                      "        return s.recv(4)\n"),
    "core/spawn.py": ("import multiprocessing as mp\n\ndef f():\n"
                      "    return mp.Process(target=lambda: 1)\n"),
    "tools/clock.py": ("import time\n\ndef f(t0):\n"
                       "    return time.time() - t0\n"),
    "core/supp.py": "def f(p):\n    return open(p)  # jbplint: disable=JBP002\n",
    "core/broken.py": "def oops(:\n",
}


def _findings(res, rename=None):
    out = []
    for f in res.findings:
        msg = f.message if rename is None else f.message.replace(*rename)
        out.append((f.rule, f.path, f.line, f.col, f.symbol, f.key, msg))
    return out, res.suppressed, res.baselined, res.files


@pytest.mark.parametrize("tree", ["src/repro", "src/repro_torch",
                                  "every-rule"])
def test_port_linter_gives_the_reference_linters_findings(tmpdir_path,
                                                          tree):
    from repro.analysis import analyze_paths as ref_analyze_paths
    if tree == "every-rule":
        for rel, body in _EVERY_RULE.items():
            _src(tmpdir_path, rel, body)
        root = tmpdir_path
    else:
        root = REPO / tree
    port = _findings(analyze_paths([root]),
                     rename=("repro_torch.core.", "repro.core."))
    ref = _findings(ref_analyze_paths([root]))
    assert port == ref
    if tree == "every-rule":
        assert sorted({f[0] for f in port[0]}) == [
            PARSE_RULE, "JBP001", "JBP002", "JBP003", "JBP004", "JBP005",
            "JBP006"]
        assert port[1] == 1
