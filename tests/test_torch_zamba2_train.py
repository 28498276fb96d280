"""zamba2-2.7b training against the benchmark's plain float32 reference
(`portbench/reference/zamba2.py`), on the CPU at the smoke size with
seeded weights:
- the port's train step with its compute dtype set to float32 equals the
  reference's step to float32 rounding: the reference follows the
  repository's model equation for equation;
- the port as it runs (bf16 compute over fp32 masters) against the
  reference, leaf by leaf, each tolerance with its reason;
- the `train` runner (`portbench/runners/train.py`) through
  `run.result_line` is correct, its control and planted faults are not;
- the reference and the counts import neither the port nor JAX; the
  counts' parameter count is the port's; the train readers on a worked
  record."""
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells, run  # noqa: E402
from portbench.counts import PEAK_FLOPS, least_seconds  # noqa: E402
from portbench.counts import zamba2 as counts  # noqa: E402
from portbench.reference import zamba2 as ref  # noqa: E402
from portbench.runners import train  # noqa: E402
from repro_torch.configs.base import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

CELL = "zamba2_2.7b.train"
SEED = 2**31 + 977
SMOKE = reduce_for_smoke(get_config("zamba2-2.7b"))
#: the port's modules whose compute dtype the float32 comparison sets
COMPUTE_MODULES = ("repro_torch.models.layers", "repro_torch.models.attention",
                   "repro_torch.models.ssm", "repro_torch.models.transformer",
                   "repro_torch.models.model",
                   "repro_torch.kernels.ssd_scan.ref",
                   "repro_torch.kernels.ssd_scan.ops")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def smoke_plan(batch: int = 2, seq: int = 64):
    """The cell at the smoke size: the configuration's model numbers
    reduced as `reduce_for_smoke` reduces them, a small batch."""
    plan = cells.plan(cells.load_benchmark(), CELL)
    model = {k: getattr(SMOKE, k) for k in plan.config["model"]}
    return dataclasses.replace(
        plan, config={**plan.config, "model": model},
        mix={**plan.mix, "batch": batch, "seq_len": seq})


def failing(res: dict) -> set:
    return {k for k, c in res["checks"].items() if c["value"] > c["limit"]}


def held_step(prog, steps: int = 2):
    """`steps` steps of the program from the seed, then a held step:
    (state before it, state after it, its loss, its batch)."""
    state = prog.init(SEED)
    for i in range(steps):
        state, _ = prog.step(state, prog.batch(i))
    batch = prog.batch(steps)
    held = train._hold(state)
    state, metrics = prog.step(state, batch)
    return held, state, metrics["loss"], batch


def leaf_gaps(prog, held, after, batch) -> dict:
    """Per leaf: the program's recovered gradient, updated parameter and
    moments against the reference's step from `held`, relative L2."""
    hp = prog.ref_hp
    loss, grads = ref.loss_and_grads(
        ref.rebuilt(after["params"], held["params"]), batch, prog.dims)
    scale = ref.clip_scale(grads, hp.grad_clip)
    p, m, v = (ref.named(t) for t in (after["params"], after["opt"]["m"],
                                      after["opt"]["v"]))
    out = {}
    for k, g in grads.items():
        p0, m0, v0 = held["params"][k], held["m"][k], held["v"][k]
        p1, m1, v1 = ref.adamw_leaf(hp, held["step"], scale,
                                    ref.decayed(k, p0), p0, g, m0, v0)
        out[k] = {"grad": train._rel((m[k] - hp.b1 * m0) / (1 - hp.b1),
                                     g * scale),
                  "update": train._rel(p[k], p1, p1 - p0),
                  "m": train._rel(m[k], m1), "v": train._rel(v[k], v1)}
    return {"loss": loss, "leaves": out}


def _flash_bwd_float32(q, k, v, out, lse, do, *, causal, q_chunk,
                      kv_chunk):
    """The flash backward by autograd of the plain forward, which stays
    float32 on float32 inputs (the port's backward rounds p and ds to bf16
    whatever its inputs)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = flash_attention_plain(q, k, v, causal=causal, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
    return torch.autograd.grad(o, (q, k, v), do)


@contextlib.contextmanager
def float32_compute():
    """The port's compute dtype set to float32 in every module of the
    hybrid's path, and the flash backward's bf16 roundings taken out."""
    mods = [sys.modules[name] for name in COMPUTE_MODULES]
    saved = [m.COMPUTE_DTYPE for m in mods]
    bwd = fops.flash_attention_bwd_plain
    for m in mods:
        m.COMPUTE_DTYPE = torch.float32
    fops.flash_attention_bwd_plain = _flash_bwd_float32
    try:
        yield
    finally:
        for m, d in zip(mods, saved):
            m.COMPUTE_DTYPE = d
        fops.flash_attention_bwd_plain = bwd


def test_the_reference_is_the_ports_model_in_float32():
    """With every bf16 rounding of the port's compute taken out, the
    port's step and the reference's differ only in the order of float32
    sums (the chunked scan against the quadratic one, the online softmax
    against the whole row): loss to 1e-6, each leaf's gradient, moments
    and update to 1e-4 of its size. A wrong equation on either side moves
    some leaf by far more."""
    plan = smoke_plan()
    prog = train.Program(plan.config, plan.mix, "cpu")
    with float32_compute():
        held, after, loss, batch = held_step(prog)
    got = leaf_gaps(prog, held, after, batch)
    assert abs(float(loss) - float(got["loss"])) <= 1e-6 * float(got["loss"])
    worst = {kind: max(g[kind] for g in got["leaves"].values())
             for kind in ("grad", "update", "m", "v")}
    assert all(w <= 1e-4 for w in worst.values()), worst


def test_the_port_in_bf16_against_the_reference():
    """The port as it runs: bf16 products of the fp32 masters. The loss
    moves by bf16's rounding averaged over the tokens (5e-4 of itself);
    the gradient of a small leaf (a layer's D, a conv bias: a sum over
    every token of bf16 products) by up to 15 %, the whole tree's by 5 %
    (RMS over leaves); the update, whose AdamW scaling keeps each
    element's sign and the moments' history, by 20 % of its length; the
    new moments carry the gradient's error, m at a tenth of its weight."""
    plan = smoke_plan()
    prog = train.Program(plan.config, plan.mix, "cpu")
    held, after, loss, batch = held_step(prog)
    got = leaf_gaps(prog, held, after, batch)
    assert abs(float(loss) - float(got["loss"])) <= 5e-4 * float(got["loss"])
    leaves = got["leaves"].values()
    assert max(g["grad"] for g in leaves) <= 0.15
    assert (sum(g["grad"] ** 2 for g in leaves) / len(leaves)) ** 0.5 <= 0.05
    assert max(g["update"] for g in leaves) <= 0.2
    assert max(g["m"] for g in leaves) <= 0.15
    assert max(g["v"] for g in leaves) <= 0.3


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_at_the_smoke_size_is_correct(traced):
    plan = smoke_plan()
    res = train.run(plan, SEED, 0.0, traced, device="cpu")
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(train.LIMITS)
    rec = res["record"]
    # at least the warmup's steps, so the held step runs at the full rate
    assert rec["steps"] == plan.config["assumed"]["adamw"]["warmup_steps"]
    assert res["attempted"] == rec["steps"] + 1 and res["failed"] == 0
    assert res["summary"][0].startswith(
        f"portbench: {rec['steps']} train steps in ")
    # the held step's numbers that no limit judges are recorded and printed
    assert {"loss_gap", "grad_leaf_gap", "grad_leaves",
            "update_leaves"} <= set(rec["held"])
    assert res["summary"][1].startswith(
        f"portbench: held step {rec['held']['step']}: loss_gap ")
    line = run.result_line(plan, res, traced, {"platform": "cpu"})
    assert line["correct"] and line["checks"] == res["checks"]
    if traced:
        names = {n for n, *_ in rec["traced"]["program"]["ranges"]}
        assert {"train.step", "train.fwd_bwd", "train.adamw",
                "ssm.ssd_bwd", "attn.flash_bwd"} <= names
        # no device on the CPU: the launch count reads 0, the shares
        # nothing
        assert line["metrics"] == {"train_launches": {"value": 0.0,
                                                      "unit": "launches"}}
    else:
        assert set(line["metrics"]) == {"setup_s", "step_ms"}


def test_the_control_is_not_correct():
    """The reference's step with parameters and moments held in bf16: the
    step's update (lr 3e-4 times an AdamW ratio below 1) is below half a
    bf16 ulp of the norm scales (2^-8 at 1) and vanishes."""
    res = train.run(smoke_plan(), SEED, 0.0, False, device="cpu",
                    program=train.Control)
    assert not res["correct"]
    assert "update_gap" in failing(res), res["checks"]


class _Patched(train.Program):
    """The program with something of the port replaced for its steps."""

    @contextlib.contextmanager
    def patched(self):
        yield

    def step(self, state, batch):
        with self.patched():
            return super().step(state, batch)


class Float8Inputs(_Patched):
    """Every matmul's inputs rounded to float8 e4m3 (the gradient passed
    through)."""

    @contextlib.contextmanager
    def patched(self):
        matmul = torch.matmul

        def rounded(t):
            return t + (t.to(torch.float8_e4m3fn).to(t.dtype) - t).detach()

        torch.matmul = lambda a, b: matmul(rounded(a), rounded(b))
        try:
            yield
        finally:
            torch.matmul = matmul


class NoSkipTerm(_Patched):
    """The SSD scan without its D x term."""

    @contextlib.contextmanager
    def patched(self):
        scan = sops.ssd_scan

        def without_d(x, dt, A, B, C, D, **kw):
            return scan(x, dt, A, B, C, torch.zeros_like(D), **kw)

        sops.ssd_scan = without_d
        try:
            yield
        finally:
            sops.ssd_scan = scan


class SharedBlockSkipped(_Patched):
    """The units without the shared attention and FFN block."""

    @contextlib.contextmanager
    def patched(self):
        block = transformer.dense_block_seq
        transformer.dense_block_seq = lambda p, x, *a: (x, (None, None))
        try:
            yield
        finally:
            transformer.dense_block_seq = block


@pytest.mark.parametrize("prog,want", [
    (Float8Inputs, {"grad_gap"}),
    (NoSkipTerm, {"update_gap"}),
    (SharedBlockSkipped, {"grad_gap", "update_gap"}),
])
def test_a_planted_fault_is_not_correct(prog, want):
    res = train.run(smoke_plan(), SEED, 0.0, False, device="cpu",
                    program=prog)
    assert not res["correct"]
    assert want <= failing(res), res["checks"]


def test_a_nonfinite_loss_is_not_correct(monkeypatch):
    class NanLoss(train.Program):
        def step(self, state, batch):
            state, m = super().step(state, batch)
            return state, {**m, "loss": m["loss"] * float("nan")}

    res = train.run(smoke_plan(), SEED, 0.0, False, device="cpu",
                    program=NanLoss)
    assert not res["correct"] and res["failed"] >= 1
    assert "nonfinite" in failing(res)


def test_the_reference_and_counts_import_neither_the_port_nor_jax():
    probe = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
             "import portbench.reference.zamba2, portbench.counts.zamba2\n"
             "print(sorted({m.partition('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"repro", "repro_torch", "jax", "jaxlib"}


@pytest.mark.parametrize("cfg", [get_config("zamba2-2.7b"), SMOKE])
def test_the_parameter_count_is_the_ports(cfg):
    model = dataclasses.asdict(cfg)
    assert counts.params(model) == cfg.n_params()
    if cfg.name == "zamba2-2.7b":
        assert counts.params(model) == 2_422_670_240
        conf = cells.load_json("configs", "zamba2_2.7b")
        assert counts.params(conf["model"]) == conf["n_params"]


def test_the_configuration_is_the_registrys_at_full_size():
    conf = cells.load_json("configs", "zamba2_2.7b")
    cfg = get_config(conf["arch"])
    assert conf["reduced"] == []
    assert {k: getattr(cfg, k) for k in conf["model"]} == conf["model"]


def test_ssd_and_step_counts_worked_by_hand():
    m = {"d_model": 8, "n_heads": 2, "n_kv_heads": 2, "d_ff": 16,
         "vocab_size": 100, "vocab_pad_to": 128, "ssm_state": 4,
         "ssm_expand": 2, "ssm_headdim": 4, "ssm_conv": 4, "n_layers": 2,
         "shared_attn_interval": 2}
    # b 1, s 4, chunk 2: 2 chunks; tri 3; h 4, p 4, n 4
    c = counts.ssd_forward(m, 1, 4, 2)
    assert c["flops"] == 2 * 2 * (3 * 4 + 4 * (3 * 4 + 2 * 2 * 4 * 4))
    assert c["bytes"] == (2 * 64 + 4 * 16 + 32 + 2 * 2 * 16 + 2 * 64
                          + 4 * 64)
    assert counts.attention_flops(m, 1, 4) == 4 * 2 * 4 * 10
    per_layer = 8 + 8 * (32 + 8 + 4) + 5 * 24 + 12 + 16 + 16 * 8
    assert counts.mamba2_layer_params(m) == per_layer
    shared = 16 + 8 * 4 * 8 + 3 * 8 * 16
    assert counts.shared_block_params(m) == shared
    assert counts.params(m) == 2 * 128 * 8 + 2 * per_layer + shared + 8
    used = counts.params(m) - 128 * 8
    assert counts.train_step_flops(m, 1, 4, 2) == (
        6 * used * 4 + 3 * counts.attention_flops(m, 1, 4)
        + 3 * 2 * c["flops"])


def _record():
    """A traced step by hand: `train.step` [0, 100) us on the main thread;
    kernels launched at 10 (in `train.fwd_bwd`), 20 and 30 (in
    `ssm.ssd_bwd`, on the backward's thread), 40 (in `train.adamw`) and
    150 (after the step), the SSD forward's two kernels among them."""
    model = dict(json.loads((ROOT / "portbench/configs/zamba2_2.7b.json")
                            .read_text())["model"])
    device = [["ssd_cb_kernel<64>", "kernel", 11, 2.0, "train.fwd_bwd", 10],
              ["void ssd_chunk_scan_kernel<64>", "kernel", 13, 6.0,
               "train.fwd_bwd", 10.5],
              ["elementwise", "kernel", 21, 30.0, "ssm.ssd_bwd", 20],
              ["gemm", "kernel", 31, 12.0, "ssm.ssd_bwd", 30],
              ["Memcpy DtoD", "gpu_memcpy", 41, 8.0, "train.adamw", 40],
              ["late", "kernel", 151, 5.0, "", 150]]
    return {"model": model, "batch": 8, "seq_len": 256, "ssd_chunk": 64,
            "traced": {"window_us": 200.0, "steps": 1,
                       "device": [r[:4] for r in device],
                       "spans": [["train.step", 0.0, 100.0]],
                       "program": {"ranges": [["train.step", 0.0, 100.0]],
                                   "device": device}}}


def test_the_train_readers_on_a_worked_record():
    rec = _record()
    read = {name: cells.load_reader("layer_metrics", name).read(rec)
            for name in ("train_mfu", "train_launches", "ssd_bwd_share",
                         "ssd_scan_roofline")}
    m = rec["model"]
    # launched inside train.step: 2 + 6 + 30 + 12 + 8 = 58 us
    flops = counts.train_step_flops(m, 8, 256, 64)
    assert read["train_mfu"] == pytest.approx(
        100 * flops / PEAK_FLOPS["bf16"] / 58e-6, rel=1e-12)
    assert read["train_launches"] == 4
    assert read["ssd_bwd_share"] == pytest.approx(100 * 42 / 58, rel=1e-12)
    c = counts.ssd_forward(m, 8, 256, 64)
    assert read["ssd_scan_roofline"] == pytest.approx(
        100 * least_seconds(c["flops"], c["bytes"], "bf16") / 8e-6,
        rel=1e-12)


def test_the_train_readers_without_the_programs_ranges_give_nothing():
    """A program with no `train.step` range (the parent of the spans) and
    a run with no trace read nothing, and raise nothing."""
    rec = _record()
    rec["traced"]["spans"] = []
    rec["traced"]["program"] = {"ranges": [], "device": [
        r[:4] + ["", r[5]] for r in rec["traced"]["program"]["device"]]}
    for name in ("train_mfu", "train_launches", "ssd_bwd_share"):
        assert cells.load_reader("layer_metrics", name).read(rec) is None
    bare = {k: v for k, v in rec.items() if k != "traced"}
    for name in ("train_mfu", "train_launches", "ssd_bwd_share",
                 "ssd_scan_roofline"):
        assert cells.load_reader("layer_metrics", name).read(bare) is None
