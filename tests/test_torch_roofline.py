"""The port's roofline (`repro_torch.roofline`): the report's arithmetic
with the H100's constants, the kernels' flop formulas, and the counts of
a trace on fake tensors over a fake (2, 2) mesh against the dot FLOPs
that the JAX package's `repro.roofline.hlo_analysis.HloAnalyzer` counts
for the same cell compiled on 4 host devices (a subprocess).

Tolerances: the report's numbers exact to float64; each kernel's formula
exact against `FlopCounterMode` over its plain version where both count
the same products, and against a hand count of the tiles where the
kernel skips some; the trace's product FLOPs a device within 1 % of
XLA's dot FLOPs outside attention and the SSD scan, which the port
counts by the kernels' formulas (flash skips the tiles above the causal
diagonal, the reference's `flash_attention_jnp` runs every tile: both
printed)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import get_config, list_configs, reduce_for_smoke
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.roofline import analysis as A
from repro_torch.roofline.trace_analysis import (TraceCounter, analyze,
                                                 summarize)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_model_flops_and_tokens_match_the_jax_package():
    from repro.configs.base import get_config as jax_config
    from repro.roofline import analysis as JA
    for arch in list_configs():
        cfg, jcfg = get_config(arch), jax_config(arch)
        for case in SH.SHAPE_TABLE.values():
            args = (case.kind, case.seq, case.batch)
            assert A.tokens_for_shape(*args) == JA.tokens_for_shape(*args)
            assert A.model_flops(cfg, *args) == JA.model_flops(jcfg, *args), \
                (arch, case.name)


def test_build_report_arithmetic_with_the_h100_constants():
    assert (A.PEAK_FLOPS, A.HBM_BW, A.NVLINK_BW, A.HBM_PER_DEVICE,
            A.NODE_GPUS, A.IB_BW) == (989e12, 3.35e12, 450e9, 80e9, 8, 50e9)
    cfg = get_config("qwen1.5-0.5b")
    # 9 GB of traffic a device, 0.5 GB of it over groups that span nodes
    counts = {"flops_per_device": 2e12, "hbm_bytes_per_device": 1e10,
              "collective_traffic_per_device": 9e9,
              "collective_traffic_by_kind": {"all-reduce": 9e9},
              "collective_op_counts": {"all-reduce": 3.0},
              "collective_traffic_cross_node": 5e8,
              "io_bytes_per_device": 4e9}
    r = A.build_report(arch="qwen1.5-0.5b", shape="prefill_32k",
                       mesh_name="single", n_devices=256, counts=counts,
                       cfg=cfg, kind="prefill", seq=32768, batch=32,
                       mem_stats={"argument_bytes": 5e10,
                                  "temp_bytes": 4e10})
    assert r.compute_s == 2e12 / 989e12
    assert r.memory_s == 1e10 / 3.35e12
    assert (r.io_bytes_per_device, r.memory_lower_s) == (4e9, 4e9 / 3.35e12)
    assert r.collective_s == 8.5e9 / 450e9 + 5e8 / 50e9
    assert r.collective_cross_node_bytes_per_device == 5e8
    assert r.dominant == "collective"
    mf = 2.0 * cfg.n_params() * 32768 * 32
    assert r.model_flops == mf
    assert r.useful_flops_ratio == mf / (2e12 * 256)
    assert r.mfu_bound == (mf / (256 * 989e12)) / r.collective_s
    assert r.fits_hbm is False               # 90 GB > 80 GB
    assert r.to_dict()["collective_op_counts"] == {"all-reduce": 3.0}


def _counted(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


@pytest.mark.parametrize("S,D", [(256, 64), (384, 32)])
def test_flash_formula_against_flop_counter_of_the_plain_version(S, D):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, S, 3, D, generator=g).bfloat16()
               for _ in range(3))
    plain = _counted(flash_attention_plain, q, k, v, causal=False,
                     q_chunk=128, kv_chunk=128)
    # every tile: the plain version's products, exactly
    assert fops.flash_flops(2, 3, S, S, D, False) == plain
    # causal: a block of 128 rows runs the key tiles up to its last row,
    # a warp of 16 rows skips a tile whose first key is past its last row
    pairs = sum(min(-(-min(S, q0 + 128) // 64), (q0 + w0 + 15) // 64 + 1)
                for q0 in range(0, S, 128) for w0 in range(0, 128, 16))
    causal = fops.flash_flops(2, 3, S, S, D, True)
    assert causal == plain * pairs * 16 * 64 // (S * S)
    assert plain // 2 < causal < plain


def test_flash_formula_by_hand_at_one_block():
    # S = 128: warps 0-3 (rows 0-63) take key tile 0 only, warps 4-7 both
    # tiles: 12 (warp, tile) pairs of 16 x 64 (QK^T and PV, 2 flops each)
    assert fops.flash_flops(1, 1, 128, 128, 64, True) == 12 * 4 * 16 * 64 * 64


def test_ssd_formula_against_flop_counter_of_the_plain_version():
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n, chunk = 2, 128, 3, 32, 16, 32
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g) * 0.1
    A_, D_ = -torch.linspace(1.0, 2.0, h), torch.ones(h)
    B_ = torch.randn(b, s, n, generator=g)
    plain = _counted(ssd_chunked, x, dt, A_, B_, B_, D_, chunk=chunk)
    assert sops.ssd_flops(b, s, h, p, n, chunk, kernel=False) == plain
    # the kernel: 3 of the 4 16 x 16 tiles of a 32-step chunk, and the
    # scan's products twice (hi and lo halves of the fp32 operand)
    nc = s // chunk
    cb = 3 * 2 * 16 * 16 * n
    scan = 2 * (3 * 2 * 16 * 16 * p + 2 * 2 * chunk * n * p)
    assert sops.ssd_flops(b, s, h, p, n, chunk) == b * nc * (cb + h * scan)


def test_fake_tensors_go_to_the_custom_ops_with_their_formulas():
    with FakeTensorMode():
        q = torch.empty(2, 256, 4, 64, dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            out, lse = fops.flash_forward(q, q, q, causal=True)
        assert fc.get_total_flops() == fops.flash_flops(2, 4, 256, 256, 64,
                                                        True)
        assert (out.shape, out.dtype) == (q.shape, torch.bfloat16)
        assert (lse.shape, lse.dtype) == ((2, 4, 256), torch.float32)
        x = torch.empty(2, 200, 4, 64, dtype=torch.bfloat16)
        B_ = torch.empty(2, 200, 16, dtype=torch.bfloat16)
        dt, A_ = torch.empty(2, 200, 4), torch.empty(4)
        with FlopCounterMode(display=False) as fc:
            y, st = sops.ssd_scan(x, dt, A_, B_, B_, A_, chunk=128)
        # padded to 2 chunks of 128
        assert fc.get_total_flops() == sops.ssd_flops(2, 256, 4, 64, 16, 128)
        assert y.shape == (2, 200, 4, 64) and st.shape == (2, 4, 64, 16)
        assert st.dtype == torch.float32


# ------------------------------------- the trace against XLA's dot FLOPs
_JAX_DOTS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs.base import get_config, reduce_for_smoke
from repro.launch import shapes as SH
from repro.launch.dryrun import step_fn_for
from repro.launch.mesh import compat_make_mesh
from repro.meshctx import use_mesh
from repro.roofline import hlo_analysis as H

out = {}
mesh = compat_make_mesh((2, 2), ("data", "model"))
for arch, shape in json.loads(sys.argv[1]):
    cfg = reduce_for_smoke(get_config(arch))
    spec = SH.input_specs(cfg, shape, mesh)
    fn = step_fn_for(cfg, spec["kind"], shape)
    with use_mesh(mesh):
        text = jax.jit(fn, in_shardings=spec["in_shardings"]).lower(
            *spec["args"]).compile().as_text()
    an = H.HloAnalyzer(text, 4)
    # the dots alone: no elementwise op, no reduce
    for instrs in an.comps.values():
        if isinstance(instrs, list):
            for ins in instrs:
                if ins.op in ("reduce", "reduce-window"):
                    ins.op = "reduce-uncounted"
    saved = set(H.ELEMENTWISE)
    H.ELEMENTWISE.clear()
    out[f"{arch}/{shape}"] = an.cost().flops
    H.ELEMENTWISE.update(saved)
print(json.dumps(out))
"""
CELLS = [("qwen1.5-0.5b", "prefill_32k"), ("qwen1.5-0.5b", "decode_32k"),
         ("zamba2-2.7b", "prefill_32k"), ("zamba2-2.7b", "decode_32k")]


@pytest.fixture(scope="module")
def jax_dots():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_DOTS, json.dumps(CELLS)],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _port_counts(arch, shape, mesh_shape=(2, 2)):
    """Rank 0's counts of one step of the smoke config at `shape` on a
    fake mesh, and the products by op."""
    cfg = reduce_for_smoke(get_config(arch))
    seen = {}
    real_exit = TraceCounter.__exit__

    def keep(self, *a):
        seen["by_op"] = dict(self.by_op)
        return real_exit(self, *a)
    TraceCounter.__exit__ = keep
    try:
        with DR.fake_world(4):
            mesh = make_mesh(mesh_shape, ("data", "model"),
                             device_type="cpu")
            res = DR.trace_cell(cfg, shape, mesh)
    finally:
        TraceCounter.__exit__ = real_exit
    return cfg, res, seen["by_op"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_product_flops_match_xla_dots_outside_the_kernels(jax_dots, arch,
                                                          shape):
    cfg, res, by_op = _port_counts(arch, shape)
    case = SH.SHAPE_TABLE[shape]
    products = res["counts"]["product_flops_per_device"]
    flash = by_op.get("flash_fwd", [0, 0.0])[1]
    ssd = by_op.get("ssd_scan", [0, 0.0])[1]
    B = case.batch // 2                         # over data
    n_attn = (cfg.n_layers // cfg.shared_attn_interval
              if cfg.family == "hybrid" else cfg.n_layers)
    H = -(-cfg.n_heads // 2)                   # padded q-heads over model
    D = cfg.resolved_head_dim
    jax_attn = jax_ssd = 0
    if case.kind == "prefill":
        S = case.seq
        # the kernel's tiles, and the reference's every tile
        assert flash == n_attn * fops.flash_flops(B, H, S, S, D, True)
        jax_attn = n_attn * 4 * B * H * S * S * D
        if cfg.family == "hybrid":
            h = cfg.n_ssm_heads // 2
            args = (B, S, h, cfg.ssm_headdim, cfg.ssm_state, 128)
            n_ssm = cfg.n_layers
            assert ssd == n_ssm * sops.ssd_flops(*args)
            jax_ssd = n_ssm * sops.ssd_flops(*args, kernel=False)
    jax_total = jax_dots[f"{arch}/{shape}"]
    ours = products - flash - ssd
    theirs = jax_total - jax_attn - jax_ssd
    print(f"{arch} {shape}: port products {products:.6e} (flash {flash:.6e}"
          f", ssd {ssd:.6e}); XLA dots {jax_total:.6e} (attention "
          f"{jax_attn:.6e}, ssd {jax_ssd:.6e}); outside {ours:.6e} vs "
          f"{theirs:.6e}")
    assert abs(ours - theirs) <= 0.01 * theirs


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_collectives_of_a_1x4_decode_by_hand(shape):
    """The dense smoke config's decode step, and its prefill, on a (1, 4)
    mesh, against the collectives of the reference's HLO for the same
    cell on 4 host devices (`HloAnalyzer`). XLA all-reduces once a
    row-parallel product: the attention output and the FFN down a layer,
    and the vocab-parallel embedding, 2L + 1 all-reduces of bf16 [B,S,d]
    (the CPU build widens them to f32; the analyzer, and a GPU or TPU
    build, count bf16). The prefill adds XLA's all-gather of k and of v a
    layer for the reference's `take` of the kv heads, 2L of bf16
    [B,S,Hkv,hd] (f32 in the CPU build, whose all-gathers the analyzer
    does not narrow). Nothing else moves: the weights lie whole over the
    absent data axis, the cache's heads over `model`. Read off the HLO of
    this config: decode 9 all-reduces of 32,768 bytes; prefill 9 of
    268,435,456 and 8 all-gathers of 536,870,912 (f32). The port issues
    exactly these (`local_map` all-reduces a partial sum at its site;
    `_take_heads` gathers the kv heads once), each moving what the ring
    reckoning gives for its shape. The 4 ranks share a node: no traffic
    crosses one."""
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    case = SH.SHAPE_TABLE[shape]
    B, d, L = case.batch, cfg.d_model, cfg.n_layers
    S = 1 if case.kind == "decode" else case.seq
    with DR.fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
        spec = SH.input_specs(cfg, shape, mesh)
        from torch.distributed.tensor.debug import CommDebugMode
        with FakeTensorMode(), DR._offsets_off_fake():
            args = [DR.fake_dtensors(a, s) for a, s in
                    zip(spec["args"], spec["in_shardings"])]
            with torch.no_grad(), CommDebugMode() as comm, \
                    TraceCounter() as tc:
                if case.kind == "decode":
                    M.decode_step(args[0], cfg, args[2], args[1], 100)
                else:
                    M.prefill(args[0], cfg, args[1], q_chunk=1024,
                              kv_chunk=1024)
    got = summarize(tc)
    want = {"all-reduce": 2 * L + 1}
    if case.kind == "prefill":
        want["all-gather"] = 2 * L
    assert got["collective_op_counts"] == want
    assert sum(comm.get_comm_counts().values()) == sum(want.values())
    f = 3 / 4                                   # (g - 1) / g
    kv = 2 * B * S * cfg.n_kv_heads * cfg.resolved_head_dim
    one_op = {"all-reduce": 2 * (2 * B * S * d) * f, "all-gather": kv * f}
    assert got["collective_traffic_by_kind"] == {
        k: c * one_op[k] for k, c in want.items()}
    assert got["collective_traffic_cross_node"] == 0.0


_JAX_COLLECTIVES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs.base import get_config, reduce_for_smoke
from repro.launch import shapes as SH
from repro.launch.dryrun import step_fn_for
from repro.launch.mesh import compat_make_mesh
from repro.meshctx import use_mesh
from repro.roofline import hlo_analysis as H

arch, shape = sys.argv[1:3]
mesh = compat_make_mesh((2, 2), ("data", "model"))
cfg = reduce_for_smoke(get_config(arch))
spec = SH.input_specs(cfg, shape, mesh)
fn = step_fn_for(cfg, spec["kind"], shape)
with use_mesh(mesh):
    text = jax.jit(fn, in_shardings=spec["in_shardings"]).lower(
        *spec["args"]).compile().as_text()
out = H.analyze(text, 4)
seq = SH.SHAPE_TABLE[shape].seq


class Narrowed(H.HloAnalyzer):
    # an activation's all-gather, f32 [b, S, ...] in the CPU build, bf16 in
    # the reference's code (k and v, the hidden states), at bf16
    def _collective_bytes(self, ins, comp):
        b = super()._collective_bytes(ins, comp)
        dims = H.shape_dims(ins.type_str)
        if (ins.op.startswith("all-gather")
                and ins.type_str.startswith("f32[")
                and len(dims) >= 3 and dims[1] == seq):
            return b / 2.0
        return b


narrowed = sum(r.traffic_bytes for r in Narrowed(text, 4).cost().collectives)
print(json.dumps({**{k: out[k] for k in ("collective_op_counts",
                                         "collective_traffic_per_device")},
                  "narrowed_traffic_per_device": narrowed}))
"""


def test_collectives_of_a_2x2_train_step_against_xla():
    """smollm-360m's smoke `train_4k` step (L = 4, batch 256 x 4096 in 8
    microbatches of 32, remat) on a fake (2, 2) ("data", "model") mesh,
    against `HloAnalyzer`'s counts on the reference's HLO for the same
    cell on 4 host devices: no more of each kind than XLA issues, no
    reduce-scatter, no more traffic a device than XLA's with its
    all-gathers at the reference's dtypes. Op by op (a microbatch "mb", a
    layer "l"):

    - all-reduce, port 285: the attention output's and FFN down's partial
      sums (`local_map(partial=)`), 2 a l and mb, and the attention
      output's again in the remat recompute (torch's checkpoint stops its
      recompute before the FFN down, whose output the backward does not
      need); the cotangents read whole over `model`, reduced once
      (`meshctx.reduce_grad`): the attention input's (q, k, v) and the
      FFN input's (gate, up) at their norms, and the kv heads each rank
      took its own of, k and v; the layer's weight gradients in one flat
      buffer when its backward ends (`meshctx.reduce_grads_once`): 8 a l
      and mb; a mb: the embedding's partial rows, the unembedding input's
      cotangent, the token count; a step: the tables' gradients and the
      final norm's in one bucket (`meshctx.reduce_partials`), the grad
      norm's and the metrics' scalars over "data" and "model" (2 + 2):
      8 x (4 x 8 + 3) + 5 = 285. XLA 299: the same products' 4 a l and
      mb (its remat recomputes the FFN down's too), the attention
      input's cotangent tupled with k's and with v's (2), the FFN input's
      two (1), a tuple of the layer's weight gradients (1); a mb: the
      unembedding input's cotangent (tupled with a [B, S] row), the
      vocab-parallel cross-entropy's two [B, S] reductions, the table's
      gradient, the token count; a step: 3 tuples of scalars:
      8 x (4 x 8 + 5) + 3 = 299.
    - all-gather, port 587: the ZeRO-3 gathers of a layer's 7 weights and
      the kv heads' k and v (`attention._take_heads`), each in the
      forward and the recompute, 18 a l and mb; the logits for the
      cross-entropy, 1 a mb; the tied table once a step
      (`train.step._gather_tables`); the batch's tokens and labels,
      gathered whole before they are cut into microbatches
      (`train.step._rows`), 2: 8 x 73 + 3.
      XLA 587: the same 18 a l and mb, a [B, S, d] gather a mb, and the
      tables' 3 (hoisted out of the microbatch loop).
    - XLA's 2 all-to-alls are the batch's reshape into microbatches (the
      port's 2 gathers above); its 9 collective-permutes move the table
      between its vocab- and feature-sharded layouts, which the port
      never changes (its gradient goes with the bucket).
    - reduce-scatter: none in either. A weight's gradient comes back from
      its ZeRO-3 gather partial over "data" (`meshctx.local_map`), is
      all-reduced with the layer's others and sliced to the rank's shard,
      as XLA's CPU build all-reduces the tuple.

    Traffic a device (torch 2.13, this host): the port 5,662,540,912
    bytes (its kv gathers bf16 at 1,073,741,824, as XLA's narrowed; the
    logits' gather f32 [32, 4096, 256] 8 x 67,108,864, where XLA gathers
    bf16 [16, 4096, 128]); before the backward was reduced once, 346 /
    312 reduce-scatters / 666, 5,121,843,624. XLA 7,807,912,048 as
    `HloAnalyzer` counts it, with its all-gathers at f32 (the CPU build
    widens them); 6,667,061,360 with its activations' all-gathers ([b, S,
    ...]: k and v, the hidden states; bf16 in the reference) at bf16,
    the figure the port is held to. The weights' gathers stay f32 in
    both: the params are f32 and both gather them before the cast."""
    cfg, res, _ = _port_counts("smollm-360m", "train_4k")
    got = res["counts"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_COLLECTIVES,
                        "smollm-360m", "train_4k"], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    xla = json.loads(r.stdout.strip().splitlines()[-1])
    ops, xops = got["collective_op_counts"], xla["collective_op_counts"]
    traffic = got["collective_traffic_per_device"]
    print(f"port {ops} {traffic:.0f} B; XLA {xops} "
          f"{xla['collective_traffic_per_device']:.0f} B, narrowed "
          f"{xla['narrowed_traffic_per_device']:.0f} B")
    assert ops == {"all-gather": 587.0, "all-reduce": 285.0}
    assert "reduce-scatter" not in ops
    for kind in ("all-reduce", "all-gather"):
        assert ops[kind] <= xops[kind], kind
    assert (ops["all-gather"] + ops.get("all-to-all", 0)
            <= xops["all-gather"] + xops.get("all-to-all", 0))
    assert traffic == pytest.approx(5_662_540_912, rel=1e-3)
    assert traffic <= xla["narrowed_traffic_per_device"]


@pytest.mark.parametrize("shape,cross", [((2, 8), False), ((1, 16), True)])
def test_a_group_that_spans_nodes_is_counted_apart(shape, cross):
    """An all-gather over `model` on 16 fake ranks: 8 wide, each group is
    one node of 8 consecutive ranks (NVLink); 16 wide, it spans two
    (InfiniBand)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with DR.fake_world(16):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Replicate(), Shard(1)])
            with TraceCounter() as tc:
                x.redistribute(mesh, [Replicate(), Replicate()])
    got = summarize(tc)
    g = shape[1]
    assert got["collective_op_counts"] == {"all-gather": 1.0}
    traffic = 64 * 32 * 4 * (g - 1) / g
    assert got["collective_traffic_per_device"] == traffic
    assert got["collective_traffic_cross_node"] == (traffic if cross
                                                    else 0.0)


def test_a_heads_sharded_step_counts_a_quarter_of_the_one_device_products():
    """The same decode on (1, 4) and on (1, 1): the per-device products
    outside the embedding are a quarter (every product splits its heads,
    d_ff or vocab over `model`)."""
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    counts = {}
    for shape in ((1, 4), (1, 1)):
        with DR.fake_world(shape[1]):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            spec = SH.input_specs(cfg, "decode_32k", mesh)
            with FakeTensorMode(), DR._offsets_off_fake():
                args = [DR.fake_dtensors(a, s) for a, s in
                        zip(spec["args"], spec["in_shardings"])]
                with torch.no_grad(), TraceCounter() as tc:
                    M.decode_step(args[0], cfg, args[2], args[1], 100)
        counts[shape] = tc.product_flops
    assert counts[(1, 4)] * 4 == counts[(1, 1)]


def test_a_trace_on_real_tensors_counts_what_runs():
    """On plain CPU tensors the counter sees the same products as
    `FlopCounterMode` and the bytes of each op's inputs and outputs."""
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    with TraceCounter() as tc:
        torch.relu(a @ b).sum()
    assert tc.product_flops == 2 * 64 * 128 * 32
    assert tc.flops == 2 * 64 * 128 * 32 + 64 * 32 + 64 * 32
    assert tc.bytes == 4 * ((64 * 128 + 128 * 32 + 64 * 32)
                            + 2 * 64 * 32 + 64 * 32 + 1)
    assert dataclasses.is_dataclass(A.RooflineReport)


def test_io_bytes_counts_each_input_and_output_once():
    """`analyze`'s lower bound of the traffic: a cache written in place
    and returned counts once, a view of an input adds nothing."""
    cache, x = torch.zeros(64, 32), torch.randn(8, 32)

    def step(cache, x):
        cache[:8].copy_(x)
        return cache, cache[:8], x.sum()
    got = analyze(step, cache, x)
    assert got["io_bytes_per_device"] == 4 * (64 * 32 + 8 * 32 + 1)
