"""The port's training pieces against the JAX package's, on the CPU:
AdamW (`optim/adamw.py`), int8 error feedback (`optim/grad_compress.py`),
the synthetic token pipeline (`data/pipeline.py`), the loss and its
gradients for every family (`models/model.py::loss_fn`, mirroring
`tests/test_models.py::test_forward_and_grad`), the flash and SSD
autograd Functions against `jax.vjp` / `jax.grad` of the reference's jnp
code, and remat (activation checkpointing) on against off. Each
comparison states its tolerance and why."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import flatten_state as jflatten
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduce_for_smoke as jreduce
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro_torch.ckpt.checkpoint import Stacked, flatten_state
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens, to_device
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw, grad_compress
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten

FAMILIES = ["qwen3-4b", "musicgen-large", "deepseek-moe-16b", "mamba2-2.7b",
            "zamba2-2.7b", "llama-3.2-vision-90b"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().cpu().numpy()


def _stacked_np(tree) -> dict:
    """A port tree as the JAX package's flat names -> float32 arrays."""
    out = {}
    for name, v in flatten_state(tree).items():
        t = torch.stack(v.parts).reshape(v.shape) if isinstance(v, Stacked) \
            else v
        out[name] = _np(t)
    return out


# ------------------------------------------------------------------ AdamW
def _opt_tree(rng):
    return {"w": rng.normal(size=(6, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "layers": {"k": rng.normal(size=(2, 3, 3)).astype(np.float32)}}


@pytest.mark.parametrize("step", [0, 3, 7, 25])
def test_adamw_update_matches_jax(step):
    """Params, m, v, grad norm and lr after one update, from the same
    state (float32 elementwise arithmetic in the same order: rtol 1e-6;
    the 1-d leaf gets no weight decay in either)."""
    rng = np.random.default_rng(step)
    p, g = _opt_tree(rng), _opt_tree(rng)
    g = {k: (v * 3.0 if k == "w" else v) for k, v in g.items()}   # clip
    m = jax.tree_util.tree_map(lambda a: 0.1 * a, _opt_tree(rng))
    v = jax.tree_util.tree_map(lambda a: 0.01 * a * a, _opt_tree(rng))
    hp = dict(lr=1e-2, warmup_steps=5, total_steps=20, grad_clip=1.0)
    jp, jo, jm = jadamw.adamw_update(
        p, g, {"m": m, "v": v}, jnp.asarray(step, jnp.int32),
        jadamw.AdamWConfig(**hp))
    t = lambda tree: jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)
    tp, tg, tm, tv = t(p), t(g), t(m), t(v)
    before = tp["w"]
    op, oo, om = adamw.adamw_update(tp, tg, {"m": tm, "v": tv},
                                    torch.tensor(step, dtype=torch.int32),
                                    adamw.AdamWConfig(**hp))
    assert op["w"] is before                        # updated in place
    for a, b in ((jp, op), (jo["m"], oo["m"]), (jo["v"], oo["v"])):
        for x, y in zip(jax.tree_util.tree_leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(_np(y), np.asarray(x), rtol=1e-6,
                                       atol=1e-8)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(om[k]), float(jm[k]), rtol=1e-6)


def test_schedule_matches_jax():
    hp = dict(lr=3e-4, warmup_steps=20, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 10, 20, 21, 60, 99, 100, 150):
        np.testing.assert_allclose(
            float(adamw.schedule(adamw.AdamWConfig(**hp), torch.tensor(s))),
            float(jadamw.schedule(jadamw.AdamWConfig(**hp),
                                  jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_init_opt_state_is_fp32_zeros_of_every_leaf():
    params = {"a": torch.ones(3, 2, dtype=torch.bfloat16),
              "l": [{"w": torch.ones(4)}, {"w": torch.ones(4)}]}
    st = adamw.init_opt_state(params)
    for t in tree_leaves(st["m"]) + tree_leaves(st["v"]):
        assert t.dtype == torch.float32 and not t.any()
    assert st["m"]["l"][1]["w"].shape == (4,)


def test_tree_order_is_jax_order():
    tree = {"b": [torch.tensor(1.), {"z": torch.tensor(2.),
                                     "a": torch.tensor(3.)}],
            "a": torch.tensor(4.)}
    assert [float(t) for t in tree_leaves(tree)] == [4., 1., 3., 2.]
    back = tree_unflatten(tree, [t * 10 for t in tree_leaves(tree)])
    assert float(back["b"][1]["z"]) == 20.0 and list(back) == ["b", "a"]
    assert float(tree_map(lambda t: t + 1, tree)["a"]) == 5.0


# ------------------------------------------------------- grad compression
def test_quantize_rounds_half_to_even_like_jnp():
    x = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5], np.float32)
    q, scale = grad_compress.quantize(torch.from_numpy(x))
    jq, jscale = jgc.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [127, 2, -4, 0, 0, 2]
    assert float(scale) == float(jscale)


def test_compress_with_feedback_matches_jax():
    """Two steps of error feedback: the int8 round trip and the residual
    are the same float32 operations in the same order (exact)."""
    rng = np.random.default_rng(1)
    grads = {"w": rng.normal(size=(8, 5)).astype(np.float32),
             "layers": [rng.normal(size=(3,)).astype(np.float32),
                        rng.normal(size=(3,)).astype(np.float32)]}
    jgrads = {"w": grads["w"], "layers": list(grads["layers"])}
    tg = tree_map(lambda a: torch.from_numpy(a), grads)
    tres = grad_compress.init_residuals(tg)
    jres = jgc.init_residuals(jgrads)
    for _ in range(2):
        tdeq, tres = grad_compress.compress_with_feedback(tg, tres)
        jdeq, jres = jgc.compress_with_feedback(jgrads, jres)
        for a, b in ((jdeq, tdeq), (jres, tres)):
            for x, y in zip(jax.tree_util.tree_leaves(a), tree_leaves(b)):
                np.testing.assert_array_equal(_np(y), np.asarray(x))


# ------------------------------------------------------------ data pipeline
@pytest.mark.parametrize("vocab,seq,batch,shards", [(1000, 32, 8, 1),
                                                    (49152, 64, 4, 2),
                                                    (17, 5, 6, 3)])
def test_synthetic_tokens_bit_identical_to_jax(vocab, seq, batch, shards):
    for shard in range(shards):
        a = SyntheticTokens(vocab, seq, batch, seed=5, n_shards=shards,
                            shard_id=shard)
        b = JSyntheticTokens(vocab, seq, batch, seed=5, n_shards=shards,
                             shard_id=shard)
        for step in (0, 1, 17):
            x, y = a.batch_at(step), b.batch_at(step)
            for k in ("tokens", "labels"):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def test_pipeline_rejects_indivisible_shards():
    with pytest.raises(ValueError, match="not divisible by n_shards"):
        SyntheticTokens(100, 8, global_batch=10, n_shards=3)


def test_data_pipeline_determinism():
    d1 = SyntheticTokens(1000, 32, 8, seed=3)
    d2 = SyntheticTokens(1000, 32, 8, seed=3)
    np.testing.assert_array_equal(d1.batch_at(17)["tokens"],
                                  d2.batch_at(17)["tokens"])
    sh0 = SyntheticTokens(1000, 32, 8, seed=3, n_shards=2, shard_id=0)
    sh1 = SyntheticTokens(1000, 32, 8, seed=3, n_shards=2, shard_id=1)
    assert sh0.batch_at(5)["tokens"].shape == (4, 32)
    assert not np.array_equal(sh0.batch_at(5)["tokens"],
                              sh1.batch_at(5)["tokens"])


def test_prefetcher_delivers_batches_in_order_on_the_device():
    src = SyntheticTokens(500, 16, 4, seed=1)
    pf = Prefetcher(src, start_step=3, depth=2, device="cpu")
    try:
        for step in (3, 4, 5, 6):
            b = pf.next()
            assert isinstance(b["tokens"], torch.Tensor)
            np.testing.assert_array_equal(b["tokens"].numpy(),
                                          src.batch_at(step)["tokens"])
    finally:
        pf.stop()
    host = Prefetcher(src, depth=1)
    try:
        assert isinstance(host.next()["labels"], np.ndarray)
    finally:
        host.stop()
    t = to_device({"x": np.arange(4, dtype=np.int32)}, "cpu")["x"]
    assert t.dtype == torch.int32 and t.tolist() == [0, 1, 2, 3]


# ------------------------------------------------------- loss and gradients
def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    b["labels"][0, :5] = -100
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        del b["tokens"]
    return b


def _port_grads(cfg, params, batch, **kw):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss, metrics = M.loss_fn(tree_unflatten(params, leaves), cfg,
                              {k: torch.from_numpy(v) for k, v in
                               batch.items()}, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss, metrics, tree_unflatten(params, grads)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    """loss_fn and its gradients from the JAX package's params, against
    jax.value_and_grad (jitted) of its loss_fn. bf16 rounds at the same
    points in both, but XLA fuses and sums in other orders: loss within
    1e-3, aux (moe) within 1e-2 relative, all gradients together within
    6 % (relative norm), and each leaf within 25 % (a scalar gate's or a
    norm scale's gradient is one long bf16 sum)."""
    jcfg, cfg = jreduce(jget_config(arch)), reduce_for_smoke(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    kw = dict(q_chunk=16, kv_chunk=16, ssd_chunk=16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jb, **kw), has_aux=True))(jp)
    tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    tl, tm, tg = _port_grads(cfg, tp, batch, **kw)
    assert abs(float(tl) - float(jl)) < 1e-3
    assert float(tm["tokens"]) == float(jm["tokens"]) == 59.0
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-2)
    if cfg.family == "moe":
        assert float(tm["aux"]) > 0
    jf = {k: np.asarray(v, np.float32) for k, v in jflatten(jg).items()}
    tf = _stacked_np(tg)
    assert sorted(tf) == sorted(jf)
    num = den = 0.0
    for name, want in jf.items():
        got = tf[name]
        assert got.shape == want.shape, name
        err, ref = np.linalg.norm(got - want), np.linalg.norm(want)
        num, den = num + err ** 2, den + ref ** 2
        assert err <= 0.25 * ref + 1e-12, (name, err / max(ref, 1e-30))
    assert math.sqrt(num / den) < 6e-2
    if cfg.family == "audio":               # embeddings bypass the table
        assert not tf["embed/table"].any()


def test_moe_gradient_reaches_experts_and_router():
    cfg = reduce_for_smoke(get_config("deepseek-moe-16b"))
    params = M.init_params(cfg, 0, device="cpu")
    _, _, g = _port_grads(cfg, params, _batch(cfg))
    layer = g["stack"]["layers"][0]["moe"]
    for name in ("gate", "up", "down"):
        assert layer["experts"][name].abs().sum() > 0, name
    assert layer["router"].abs().sum() > 0


# --------------------------------------------------- the kernels' Functions
def _ulps2(top: float) -> float:
    """Two bf16 ulps of the largest magnitude `top`."""
    return 2 * 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("causal,sq,skv,chunk", [(True, 64, 64, 16),
                                                 (True, 48, 48, 48),
                                                 (False, 32, 80, 16),
                                                 (False, 64, 64, 32)])
def test_flash_function_backward_matches_jax_vjp(causal, sq, skv, chunk):
    """The Function's out, dq, dk, dv against jax.vjp of
    `flash_attention_jnp` (the custom VJP `_flash_bwd_impl`) on the same
    bf16 inputs and cotangent: within two bf16 ulps of each output's
    largest value (fp32 sums in another order, then one bf16 rounding)."""
    rng = np.random.default_rng(sq + skv)
    B, H, D = 2, 3, 32
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, skv, H, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jout, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention_jnp(
        q, k, v, causal=causal, q_chunk=chunk, kv_chunk=chunk),
        bf(q), bf(k), bf(v))
    jgrads = vjp(bf(do))
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    out = fops.flash_attention(tq, tk, tv, causal=causal, qc=chunk,
                               kc=chunk)
    out.backward(torch.from_numpy(do).bfloat16())
    for want, got in ((jout, out), *zip(jgrads, (tq.grad, tk.grad,
                                                 tv.grad))):
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.bfloat16
        top = float(np.abs(want).max())
        assert float(np.abs(_np(got) - want).max()) <= _ulps2(top)


def test_flash_lse_is_the_natural_log_sum_exp_of_scaled_scores():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 16))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    out, lse = fops.flash_forward(q, k, v, causal=True, qc=16, kc=8)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 4.0
    mask = torch.ones(40, 40, dtype=torch.bool).tril()
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    assert lse.shape == (1, 2, 40) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)
    assert torch.equal(out, fops.flash_attention(q, k, v, causal=True,
                                                 qc=16, kc=8))


def test_flash_without_grad_takes_the_serving_path():
    q = torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16, requires_grad=True)
    with torch.no_grad():
        out = fops.flash_attention(q, q, q)
    assert out.grad_fn is None
    assert fops.flash_attention(q, q, q).grad_fn is not None


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 16), (40, 16)])
def test_ssd_function_backward_matches_jax_grad(s, chunk):
    """Gradients of every input of the scan (x, dt, A, B, C, D and the
    initial state) through the SsdScan Function against jax.grad of
    `ssd_chunked`, float32 inputs: relative 1e-5 of each gradient's
    largest value (float32 sums in another order). A ragged s (40) pads
    to whole chunks inside the wrapper, as in the forward; JAX gets the
    same zero padding."""
    b, h, p, n = 2, 3, 8, 16
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * 0.2).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = np.linspace(0.5, 1.5, h).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) * 0.1
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dfin = rng.standard_normal((b, h, p, n)).astype(np.float32)
    pad = (-s) % chunk

    def jf(x, dt, A, B, C, D, h0):
        padw = lambda a: jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] *
                                 (a.ndim - 2))
        y, fin = jssm.ssd_chunked(padw(x), padw(dt), A, padw(B), padw(C), D,
                                  chunk=chunk, initial_state=h0)
        return (jnp.sum(y[:, :s].astype(jnp.float32) * dy)
                + jnp.sum(fin * dfin))

    jg = jax.grad(jf, argnums=tuple(range(7)))(x, dt, A, B, C, D, h0)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C, D,
                                                         h0)]
    y, fin = sops.ssd_scan(*ts[:6], chunk=chunk, initial_state=ts[6])
    ((y.float() * torch.from_numpy(dy)).sum()
     + (fin * torch.from_numpy(dfin)).sum()).backward()
    for want, t in zip(jg, ts):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """Above the chunk's diagonal cs_l - cs_s > 0 can overflow exp; the
    plain scan masks before the exp, so the gradient stays finite (the
    JAX package's where(tri, exp(diff), 0) gives NaN there) and the values
    are unchanged."""
    b, s, h, p, n = 1, 64, 2, 4, 8
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.full((b, s, h), 3.0, requires_grad=True)
    A = torch.tensor([-16.0, -1.0])
    Bm = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    y, _ = sops.ssd_scan(x, dt, A, Bm, Bm, torch.ones(h), chunk=64)
    y.float().sum().backward()
    assert torch.isfinite(dt.grad).all()
    jy, _ = jssm.ssd_chunked(x.numpy(), dt.detach().numpy(), A.numpy(),
                             Bm.numpy(), Bm.numpy(), np.ones(h, np.float32),
                             chunk=64)
    np.testing.assert_array_equal(_np(y), np.asarray(jy, np.float32))


# ------------------------------------------------------------------- remat
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_equals_no_remat_exactly(arch):
    """Checkpointed layer bodies recompute the same operations on the same
    inputs: loss and every gradient bit-equal on the CPU."""
    cfg = reduce_for_smoke(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    kw = dict(q_chunk=16, kv_chunk=16, ssd_chunk=16)
    l0, _, g0 = _port_grads(cfg, params, batch, remat=False, **kw)
    l1, _, g1 = _port_grads(cfg, params, batch, remat=True, **kw)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
