"""Whole runs on the CPU at a small size, past the harness's look for a
card: a sound run is correct; the control (the reference in bfloat16 in
the program's place) and each fault the cells can have, planted under
the timed path, are not."""
import dataclasses
import itertools

import pytest
import torch

from portbench import cells, check, program
from portbench.runners import pic as runner

BENCH = cells.load_benchmark()
SEED = 2**31 + 977
SMALL = dict(n_cells=256, capacity=8192, n_electrons=2000, n_ions=2000,
             n_neutrals=2000)


def small_plan(cell: str):
    """The cell at a small size; "plane.ckpt" is the `ckpt` mix on the
    write plane's configuration, kept for the cell PERF.md defers."""
    if cell == "plane.ckpt":
        plan = dataclasses.replace(
            cells.plan(BENCH, "bit1_q4.ckpt"),
            config=cells.load_json("configs", "bit1_q4_plane4"))
    else:
        plan = cells.plan(BENCH, cell)
    return dataclasses.replace(
        plan, config={**plan.config, **SMALL},
        mix={**plan.mix, "steps_per_diag": 5, "diags_per_period": 3})


@pytest.fixture(autouse=True)
def own_shm(monkeypatch, tmp_path):
    """An empty directory in /dev/shm's place: other processes on this
    host (a parallel test run) make and remove shared memory there, which
    a sealed chip machine does not."""
    shm = tmp_path / "shm"
    shm.mkdir()
    monkeypatch.setattr(runner, "SHM", shm)
    return shm


def failing(res: dict) -> set:
    return {k for k, c in res["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]]
                         + ["plane.ckpt"])
def test_a_sound_run_is_correct(cell):
    plan = small_plan(cell)
    res = runner.run(plan, SEED, 0.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    rec = res["record"]
    assert rec["periods"] == 2 and rec["steps"] == 30
    # the lines run.py prints before the result: the window, then each
    # checkpoint
    assert res["summary"][0].startswith(
        "portbench: 2 periods, 30 steps in ")
    assert "; POSIX_BYTES_WRITTEN " in res["summary"][0]
    assert [x.split(":")[1] for x in res["summary"][1:]] == [
        f" checkpoint {c['step']}" for c in rec["checkpoints"]]
    for m, reader in plan.end_to_end:
        assert reader.read(rec) > 0, m["name"]
    assert set(res["checks"]) == set(check.LIMITS) - (
        set() if plan.mix["checkpoint"] else {"ckpt_bad", "restore_bad"})
    if cell == "plane.ckpt":
        skew = cells.load_reader("layer_metrics", "plane_writer_skew")
        assert skew.read(rec) == pytest.approx(4.0)


def test_the_control_is_not_correct():
    res = runner.run(small_plan("bit1_q4.ckpt"), SEED, 0.0, False,
                     device="cpu", program=program.Control)
    assert not res["correct"]
    # bad_events, too, at the cells' size (PERF.md §3); at this size a
    # sampled step has too few events to pass its limit
    assert {"init_gap", "step_gap", "flight_gap", "diag_gap"} <= failing(res)


class _Patched(program.Program):
    """The program with `pic_step` replaced for the run's chunks; `j`
    counts the steps of one `pic_run_chunk` call from 0."""

    def step(self, real, s, cfg, j):
        raise NotImplementedError

    def run_chunk(self, state, n):
        real = self.sim.pic_step
        j = itertools.count()
        self.sim.pic_step = lambda s, cfg, draws=None: self.step(
            real, s, cfg, next(j))
        try:
            return super().run_chunk(state, n)
        finally:
            self.sim.pic_step = real


def _species(f):
    """{species: f(species)} over a state's three species."""
    return {name: f(name) for name in ("electrons", "ions", "neutrals")}


class Frozen(_Patched):
    """A step that returns its state unchanged but for its counter."""

    def step(self, real, s, cfg, j):
        return s._replace(step=s.step + 1)


class HalfStep(_Patched):
    """A step that leaves the second half of every species' slots out."""

    def step(self, real, s, cfg, j):
        out = real(s, cfg)

        def half(name):
            old, new = getattr(s, name), getattr(out, name)
            h = old.x.shape[0] // 2
            return new._replace(x=torch.cat([new.x[:h], old.x[h:]]))
        return out._replace(**_species(half))


class PushSkippedOnOddSteps(_Patched):
    """On odd steps the particles alive before the step do not move."""

    def step(self, real, s, cfg, j):
        out = real(s, cfg)
        if int(s.step) % 2 == 0:
            return out

        def still(name):
            old, new = getattr(s, name), getattr(out, name)
            return new._replace(x=torch.where(old.alive > 0, old.x, new.x))
        return out._replace(**_species(still))


class ReplayAfterFirstStep(_Patched):
    """After an eager first step, each later step of a call replays the
    first one's particles (a captured step replayed on stale inputs); key,
    counter and totals advance as they should."""

    def step(self, real, s, cfg, j):
        out = real(s, cfg)
        if j == 0:
            self.first = out
            return out
        return out._replace(**_species(lambda n: getattr(self.first, n)))


class DropsAnElectron(_Patched):
    """Each step loses the electron in the lowest live slot."""

    def step(self, real, s, cfg, j):
        out = real(s, cfg)
        e = out.electrons
        alive = e.alive.clone()
        alive[int(torch.nonzero(alive > 0)[0])] = 0.0
        return out._replace(electrons=e._replace(alive=alive))


class KeyNotAdvancedOnOddSteps(_Patched):
    def step(self, real, s, cfg, j):
        out = real(s, cfg)
        return out._replace(key=s.key) if int(s.step) % 2 else out


class AlteredDiagnostics(program.Program):
    """The electrons' density altered where it is produced."""

    def diagnostics(self, state):
        out = super().diagnostics(state)
        out["density/e"] = out["density/e"] * 1.01
        return out


class LeavesShm(program.Program):
    """A run that leaves a file in /dev/shm."""

    def init(self, seed):
        (runner.SHM / "sem.mp-left").write_bytes(b"")
        return super().init(seed)


class AlteredSave(program.InProcess):
    """A checkpoint of a state one electron's position away."""

    def save(self, state, step):
        x = state.electrons.x.clone()
        x[0] += 0.25
        super().save(state._replace(
            electrons=state.electrons._replace(x=x)), step)


class AlteredRestore(program.InProcess):
    def restore(self, like):
        got, step = super().restore(like)
        got["ions"] = got["ions"]._replace(w=got["ions"].w * 2)
        return got, step


@pytest.mark.parametrize("cell,prog,ckpt,want", [
    ("bit1_q4.steps", Frozen, None, {"step_gap"}),
    ("bit1_q4.steps", HalfStep, None, {"step_gap"}),
    ("bit1_q4.steps", PushSkippedOnOddSteps, None, {"flight_gap"}),
    ("bit1_q4.steps", ReplayAfterFirstStep, None, {"flight_gap"}),
    ("bit1_q4.steps", KeyNotAdvancedOnOddSteps, None, {"schedule_bad"}),
    ("bit1_q4.steps", DropsAnElectron, None, {"conservation"}),
    ("bit1_q4.steps", AlteredDiagnostics, None, {"diag_gap"}),
    ("bit1_q4.ckpt", program.Program, AlteredSave, {"ckpt_bad"}),
    ("bit1_q4.ckpt", program.Program, AlteredRestore, {"restore_bad"}),
    ("bit1_q4.steps", LeavesShm, None, {"shm_left"}),
])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, prog, ckpt, want):
    if ckpt is not None:
        monkeypatch.setitem(program.CHECKPOINTERS, "in_process", ckpt)
    res = runner.run(small_plan(cell), SEED, 0.0, False, device="cpu",
                     program=prog)
    assert not res["correct"]
    assert want <= failing(res), res["checks"]
