"""The train runner (`"runner": "train"`): one run of a training cell, to
`runners/__init__.py`'s contract. The cell's configuration names the
port's architecture and its numbers (`model`) and the job's settings
(`assumed`: AdamW, remat, the chunks); its mix, the batch.

The program is the port's train path as `launch/train.py` drives it
through `Trainer`: `init_train_state` from the seed, `make_train_step`
with the configuration's chunks and remat, AdamW as the launcher builds
it, and on every step `SyntheticTokens(...).batch_at(step)` copied to the
card by `to_device`. Set-up makes the weights on the card and runs one
warm step (batch 0). The window runs whole train steps (batches 1, 2,
...), at least AdamW's warmup steps, so that the held step below is taken
at the full rate, and starts none once `seconds` have passed; no
checkpoint runs.
With tracing on, the profiler covers window step `TRACED_STEP`.

The check (`held_numbers`): after the window one held step runs through
the same step function on the window's state and the next batch. The
state before it is held: the parameters copied on their device, the
moments on the host. The plain reference (`reference/zamba2.py`) then
computes the step from that copy, and each number is judged against its
limit in `LIMITS`:
- `grad_gap`: the relative L2 error of the program's clipped gradient,
  every leaf recovered from its first moment as
  (m_new - b1 m_old) / (1 - b1), against the reference's, over the whole
  tree;
- `update_gap`: over the leaves, the largest L2 distance of the
  program's parameters after the step from the reference's, over the
  length of the reference's own change: a state left unchanged reads 1;
- `nonfinite`: losses of the window and the held step that are not
  finite.
Recorded beside them and judged by no limit (`record["held"]`):
`loss_gap`, the held step's loss against the reference's, relative, and
`grad_leaf_gap`, the largest relative L2 error of one leaf's gradient,
with the leaves that gave the largest two gaps.
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
import shutil
import tempfile
import time

import torch

from portbench import check, program_trace, trace
from portbench.reference import zamba2 as ref

#: what `control.py` takes from a runner
__all__ = ["Control", "Program", "run"]

#: each number's limit, between the readings of sound runs of the
#: program and those of a lower precision than the configuration's
#: (PERF.md §3): float8 e4m3 matmul inputs below its bf16 compute,
#: bf16-held parameters and moments (`Control`) below its fp32 masters.
#: - grad_gap: bf16 compute leaves 0.014-0.071 of the whole gradient's
#:   length, most at the first steps after the warmup; float8 inputs
#:   leave 0.50-0.58, the bf16-held control 0.004 (it computes in fp32);
#: - update_gap: fp32 masters take the update to within 0.09-0.12 of its
#:   length on the noisiest leaf (the embedding, whose rows seen for the
#:   first time get AdamW's sign-like first update); a state left
#:   unchanged reads 1, as the bf16-held control does (a norm scale's
#:   half ulp is ten times the update), float8 inputs 0.43-0.47.
#: The loss is judged by no limit: float8 inputs move it by 3.5e-4 to
#: 1.4e-3 of itself, sound runs by up to 3.4e-4, so no limit has room on
#: both sides; the gradient's limit stands in its place.
LIMITS = {"grad_gap": 0.18, "update_gap": 0.5, "nonfinite": 0}
#: the window step (0 the first) the profiler covers in a traced run
TRACED_STEP = 2


class Program:
    """The port's train path, as the benchmark drives it."""

    def __init__(self, config: dict, mix: dict, device):
        from repro_torch.configs.base import get_config
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.train.step import make_train_step
        self.device = torch.device(device)
        self.cfg = dataclasses.replace(get_config(config["arch"]),
                                       **config["model"])
        job = config["assumed"]
        self.hp = AdamWConfig(**job["adamw"])
        self.step_fn = make_train_step(self.cfg, self.hp,
                                       remat=job["remat"], **job["chunks"])
        self.batch_size, self.seq_len = mix["batch"], mix["seq_len"]
        self.dims = ref.Dims.of(config["model"])
        self.ref_hp = ref.AdamW(**job["adamw"])
        self.data = None

    def init(self, seed: int):
        from repro_torch.data.pipeline import SyntheticTokens
        from repro_torch.train.state import init_train_state
        self.data = SyntheticTokens(self.cfg.padded_vocab, self.seq_len,
                                    self.batch_size, seed=seed)
        return init_train_state(self.cfg, seed, device=self.device)

    def batch(self, step: int) -> dict:
        from repro_torch.data.pipeline import to_device
        return to_device(self.data.batch_at(step), self.device)

    def step(self, state, batch):
        return self.step_fn(state, batch)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    @staticmethod
    def launches() -> dict:
        """The port's kernel launch counters (absent ones left out)."""
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.ssd_scan import ops as sops
        return {name: fn.launches for name, fn in
                (("ssd_scan", sops.ssd_scan),
                 ("flash_attention", fops.flash_attention))
                if hasattr(fn, "launches")}


class Control(Program):
    """The reference's step in the program's place, its parameters and
    moments held in bfloat16, a lower precision than the configuration's
    fp32 masters: each step computes in float32 from the held values and
    rounds the new ones back."""

    def init(self, seed: int):
        state = super().init(seed)
        low = {k: t.to(torch.bfloat16) for k, t in
               ref.named({"params": state["params"],
                          "opt": state["opt"]}).items()}
        return {**ref.rebuilt({"params": state["params"],
                               "opt": state["opt"]}, low),
                "step": state["step"]}

    def step(self, state, batch):
        loss, grads = ref.loss_and_grads(state["params"], batch, self.dims)
        scale = ref.clip_scale(grads, self.ref_hp.grad_clip)
        step = int(state["step"])
        p, m, v = (ref.named(t) for t in (state["params"], state["opt"]["m"],
                                          state["opt"]["v"]))
        with torch.no_grad():
            for k, g in grads.items():
                new = ref.adamw_leaf(self.ref_hp, step, scale,
                                     ref.decayed(k, p[k]), p[k].float(), g,
                                     m[k].float(), v[k].float())
                for dst, src in zip((p[k], m[k], v[k]), new):
                    dst.copy_(src)
            state["step"].add_(1)
        return state, {"loss": loss}


def _hold(state) -> dict:
    """The state before the held step: the parameters copied on their
    device, the moments on the host, the step counter."""
    return {"params": {k: t.detach().clone()
                       for k, t in ref.named(state["params"]).items()},
            "m": {k: t.to("cpu", copy=True)
                  for k, t in ref.named(state["opt"]["m"]).items()},
            "v": {k: t.to("cpu", copy=True)
                  for k, t in ref.named(state["opt"]["v"]).items()},
            "step": int(state["step"])}


def _finite(x: float) -> float:
    """A NaN reads infinitely far."""
    return float("inf") if x != x else x


def _rel(a, b, base=None) -> float:
    """|a - b| / |base| (|b| without `base`), L2."""
    den = float(torch.linalg.vector_norm(b if base is None else base))
    return _finite(float(torch.linalg.vector_norm(a - b)) / max(den, 1e-30))


def held_numbers(prog, held: dict, after, loss, batch) -> tuple:
    """Of the program's held step (state `after`, its loss `loss`) against
    the reference's step from `held` on the same batch: the judged
    numbers (`grad_gap`, `update_gap`), and the recorded ones (`loss_gap`,
    `grad_leaf_gap`, the leaves of the two largest gradient and update
    gaps)."""
    hp = prog.ref_hp
    ref_loss, grads = ref.loss_and_grads(
        ref.rebuilt(after["params"], held["params"]), batch, prog.dims)
    scale = ref.clip_scale(grads, hp.grad_clip)
    new_p = ref.named(after["params"])
    new_m = ref.named(after["opt"]["m"])
    err = norm = 0.0
    grad, update = {}, {}
    with torch.no_grad():
        for k, g in grads.items():
            p0 = held["params"][k].float()
            m0 = held["m"][k].to(p0.device).float()
            v0 = held["v"][k].to(p0.device).float()
            p1, _, _ = ref.adamw_leaf(hp, held["step"], scale,
                                      ref.decayed(k, p0), p0, g, m0, v0)
            g_prog = (new_m[k].float() - hp.b1 * m0) / (1 - hp.b1)
            e = float((g_prog - g * scale).square().sum())
            n = float((g * scale).square().sum())
            err, norm = err + e, norm + n
            grad[k] = _finite(math.sqrt(e / max(n, 1e-300)))
            update[k] = _rel(new_p[k].float(), p1, p1 - p0)
    judged = {"grad_gap": _finite(math.sqrt(err / max(norm, 1e-300))),
              "update_gap": max(update.values())}
    worst = {name: [[k, v] for k, v in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:2]]
        for name, gaps in (("grad_leaves", grad), ("update_leaves", update))}
    recorded = {"loss_gap": _finite(abs(float(loss) - float(ref_loss))
                                    / abs(float(ref_loss))),
                "grad_leaf_gap": max(grad.values()), **worst,
                "step": held["step"]}
    return judged, recorded


def judged(numbers: dict) -> dict:
    return {k: {"value": min(v, 1e300), "limit": LIMITS[k]}
            for k, v in numbers.items()}


def run(plan, seed: int, seconds: float, traced: bool, *, device="cuda",
        program=Program, process_start=None) -> dict:
    """The result's `correct`, `attempted`, `failed` and `checks`, the
    device's memory peak, the run's record for the readers (`record`),
    and the lines `run.py` prints before the result (`summary`)."""
    t0 = time.perf_counter() if process_start is None else process_start
    seed &= (1 << 64) - 1
    work = pathlib.Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        # ------------------------------------------------------ set-up
        prog = program(plan.config, plan.mix, device)
        state = prog.init(seed)
        state, _ = prog.step(state, prog.batch(0))
        prog.sync()
        setup_s = time.perf_counter() - t0

        # ------------------------------------------------------ window
        w0 = time.perf_counter()
        counted = prog.launches()
        least = prog.hp.warmup_steps
        losses, prof, n = [], None, 0
        while True:
            if traced and n == TRACED_STEP:
                prof = trace.profile_start()
            state, metrics = prog.step(state, prog.batch(1 + n))
            if traced and n == TRACED_STEP:
                trace.profile_stop(prof)
            losses.append(metrics["loss"].detach())
            n += 1
            if (n >= least and (not traced or n > TRACED_STEP)
                    and time.perf_counter() - w0 >= seconds):
                break
        prog.sync()
        window_s = time.perf_counter() - w0
        launches = {k: (v - counted.get(k, 0)) / n
                    for k, v in prog.launches().items()}
        peak = (torch.cuda.max_memory_allocated()
                if prog.device.type == "cuda" else 0)
        rec = {"setup_s": setup_s, "window_s": window_s, "steps": n,
               "launches": launches, "model": plan.config["model"],
               "batch": prog.batch_size, "seq_len": prog.seq_len,
               "ssd_chunk": plan.config["assumed"]["chunks"]["ssd_chunk"]}
        if prof is not None:
            rec["traced"] = _traced(prof, work)
            del prof

        # ------------------------------------------------------ check
        t_check = time.perf_counter()
        batch = prog.batch(1 + n)
        held = _hold(state)
        state, metrics = prog.step(state, batch)
        losses.append(metrics["loss"].detach())
        numbers, rec["held"] = held_numbers(prog, held, state,
                                            metrics["loss"], batch)
        loss_values = [float(x) for x in losses]
        numbers["nonfinite"] = sum(not math.isfinite(x) for x in loss_values)
        rec["loss"] = [loss_values[0], loss_values[-1]]
        rec["check_s"] = time.perf_counter() - t_check
        del held, state, batch
    finally:
        shutil.rmtree(work, ignore_errors=True)
    checks = judged(numbers)
    return {"correct": check.correct(checks), "attempted": n + 1,
            "failed": numbers["nonfinite"], "peak": peak, "record": rec,
            "checks": checks, "summary": _summary(rec)}


def _traced(prof, work: pathlib.Path) -> dict:
    """The traced step's device work, its window and, beside
    `trace.reduce_chrome_trace`'s form, the program's ranges and the
    range each device operation was launched in (`traced["program"]`,
    `program_trace.reduce`); the ranges are added to `spans`, so the
    breakdown puts idle gaps down to them."""
    path = work / "trace.json"
    prof[0].export_chrome_trace(str(path))
    out = trace.reduce_chrome_trace(path)
    if out:
        out["program"] = program_trace.reduce(path)
        out["spans"] = out["spans"] + out["program"].get("ranges", [])
        out["steps"] = 1
    path.unlink()
    return out


def _summary(rec: dict) -> list:
    """The window's steps and times, the launches a step, the losses and
    the held step's numbers that no limit judges."""
    launches = ", ".join(f"{k} {v:g}" for k, v in rec["launches"].items())
    held = rec["held"]
    return [f"portbench: {rec['steps']} train steps in "
            f"{rec['window_s']:.3f} s; set-up {rec['setup_s']:.3f} s; check "
            f"{rec['check_s']:.3f} s; launches a step: {launches}; loss "
            f"{rec['loss'][0]:.4f} -> {rec['loss'][1]:.4f}",
            f"portbench: held step {held['step']}: loss_gap "
            f"{held['loss_gap']:.3g}, grad_leaf_gap "
            f"{held['grad_leaf_gap']:.3g} ({held['grad_leaves'][0][0]})"]
