"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
on the same numpy params and inputs: routing, the group-local dispatch with
and without capacity drops, the shared-expert and dense-residual paths and
the aux loss; the MoE block (attention + MoE) in prefill and decode; the
bf16 init `chip_smoke.py` serves deepseek-moe-16b with.

JAX runs eagerly on the CPU. "ulps" are bf16 ulps of the largest value
compared (2^-7 of it): both packages round to bf16 at the same points, and
differ only where an fp32 sum taken in another order rounds the other way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduce_for_smoke as jreduce
from repro.models import model as JM
from repro.models import moe as JMoe
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig, get_config, reduce_for_smoke
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServeEngine

BF16_ULP = 2.0 ** -7
#: y of `moe_ffn`: bf16 outputs of the same roundings, bit-equal in every
#: case below when measured; one ulp allows an fp32 sum taken in another
#: order (the expert products, the fp32 combine over k) to round one bf16
#: value the other way
Y_ULPS = 1


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def assert_ulps(got, ref, ulps):
    g, r = f32(got), f32(ref)
    assert g.shape == r.shape
    err, top = np.abs(g - r).max(), np.abs(r).max()
    assert err <= ulps * BF16_ULP * top, (err, top)


def _cfgs(E=8, k=2, cf=8.0, shared=0, dense=False):
    kw = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab_size=64, n_experts=E, top_k=k,
              capacity_factor=cf, n_shared_experts=shared,
              dense_residual=dense, dense_d_ff=32 if dense else 0)
    return JModelConfig(**kw), ModelConfig(**kw)


def _to_torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _case(seed, B, S, **cfg_kw):
    """JAX's init_moe params and a bf16 input, in both packages."""
    jcfg, cfg = _cfgs(**cfg_kw)
    key = jax.random.PRNGKey(seed)
    jp = JMoe.init_moe(key, jcfg)
    x = np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                   (B, S, jcfg.d_model)), np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    return jcfg, cfg, jp, _to_torch(jp), xj, xt


def _jax_routing(jp, xj, jcfg):
    """JAX's top_e and drop mask, by the lines of `repro/models/moe.py`
    that compute them (`moe_ffn` does not return them)."""
    B, S, _ = xj.shape
    E, k = jcfg.n_experts, jcfg.top_k
    C = JMoe._capacity(S, jcfg)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", xj.astype(jnp.float32),
                                      jp["router"]), axis=-1)
    top_w, top_e = jax.lax.top_k(probs, k)
    e_flat = top_e.reshape(B, S * k)
    order = jnp.argsort(e_flat, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(e_flat, order, axis=-1)
    starts = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(E)))(sorted_e)
    seg_pos = jnp.arange(S * k)[None] - jnp.take_along_axis(
        starts, sorted_e, axis=-1)
    return np.asarray(probs), np.asarray(top_e), np.asarray(seg_pos < C)


def _kth_gap(probs, k):
    """The smallest gap between the k-th and (k+1)-th router probability
    of any token: a routing choice within fp32 rounding of a tie."""
    s = -np.sort(-probs, axis=-1)
    return float((s[..., k - 1] - s[..., k]).min()) if probs.shape[-1] > k \
        else float("inf")


def _assert_same_routing(jp, tp, xj, xt, jcfg, cfg):
    probs, j_top, j_valid = _jax_routing(jp, xj, jcfg)
    t_probs, _, t_top = moe.route(tp, xt, cfg)
    _, _, t_valid = moe.dispatch(t_top, cfg.n_experts,
                                 moe._capacity(xt.shape[1], cfg))
    gap = _kth_gap(probs, cfg.top_k)
    np.testing.assert_allclose(t_probs.numpy(), probs, rtol=1e-5, atol=1e-7)
    # a mismatch here is reported with its near-tie gap, never re-seeded
    np.testing.assert_array_equal(
        t_top.numpy(), j_top,
        err_msg=f"top_e differ; smallest k-th gap {gap:.3g}")
    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    return t_valid


@pytest.mark.parametrize("E,k", [(4, 1), (8, 2), (8, 6)])
def test_moe_ffn_matches_jax_without_drops(E, k):
    jcfg, cfg, jp, tp, xj, xt = _case(0, 2, 16, E=E, k=k, cf=float(E))
    valid = _assert_same_routing(jp, tp, xj, xt, jcfg, cfg)
    assert bool(valid.all())
    jy, jaux = JMoe.moe_ffn(jp, xj, jcfg)
    ty, taux = moe.moe_ffn(tp, xt, cfg)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    assert_ulps(ty, jy, Y_ULPS)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_moe_ffn_matches_jax_with_capacity_drops():
    # as tests/test_moe.py::test_capacity_drops_are_bounded: C = 8 slots an
    # expert for 128 assignments a group over 8 experts
    jcfg, cfg, jp, tp, xj, xt = _case(1, 2, 64, E=8, k=2, cf=0.25)
    valid = _assert_same_routing(jp, tp, xj, xt, jcfg, cfg)
    assert int((~valid).sum()) > 0
    jy, jaux = JMoe.moe_ffn(jp, xj, jcfg)
    ty, taux = moe.moe_ffn(tp, xt, cfg)
    assert_ulps(ty, jy, Y_ULPS)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # the dropped assignments really are left out: with every one kept,
    # the output moves
    _, cfg_all = _cfgs(E=8, k=2, cf=8.0)
    y_all, _ = moe.moe_ffn(tp, xt, cfg_all)
    assert float((y_all.float() - ty.float()).abs().max()) > 1e-3


@pytest.mark.parametrize("shared,dense", [(2, False), (0, True), (2, True)])
def test_shared_expert_and_dense_residual_match_jax(shared, dense):
    jcfg, cfg, jp, tp, xj, xt = _case(2, 1, 8, E=4, k=2, cf=4.0,
                                      shared=shared, dense=dense)
    assert ("shared" in tp) == bool(shared) and ("dense" in tp) == dense
    jy, _ = JMoe.moe_ffn(jp, xj, jcfg)
    ty, _ = moe.moe_ffn(tp, xt, cfg)
    assert_ulps(ty, jy, Y_ULPS)
    # the path contributes
    for name in ("shared", "dense"):
        if name in tp:
            tp2 = dict(tp, **{name: jax.tree_util.tree_map(
                torch.zeros_like, tp[name])})
            y2, _ = moe.moe_ffn(tp2, xt, cfg)
            assert float((y2.float() - ty.float()).abs().max()) > 1e-4


def test_ties_put_the_lower_expert_first_as_jax_top_k():
    jcfg, cfg, jp, tp, xj, xt = _case(3, 2, 8, E=8, k=3, cf=8.0)
    tp["router"] = torch.zeros_like(tp["router"])     # every prob 1/8
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    _, j_top, _ = _jax_routing(jp, xj, jcfg)
    _, _, t_top = moe.route(tp, xt, cfg)
    np.testing.assert_array_equal(t_top.numpy(), j_top)
    assert (t_top.numpy() == np.arange(3)).all()


def test_aux_loss_detects_imbalance_as_jax():
    jcfg, cfg, jp, tp, xj, xt = _case(4, 2, 32, E=4, k=1, cf=4.0)
    router = np.zeros((cfg.d_model, 4), np.float32)
    router[:, 0] = 10.0
    jp = dict(jp, router=jnp.asarray(router))
    tp["router"] = torch.from_numpy(router)
    xa = np.abs(f32(xj)) + 0.1
    _, jaux = JMoe.moe_ffn(jp, jnp.asarray(xa).astype(jnp.bfloat16), jcfg)
    _, taux = moe.moe_ffn(tp, torch.from_numpy(xa).bfloat16(), cfg)
    assert float(taux) > 2.0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    _, zero = moe.moe_ffn(tp, torch.from_numpy(xa).bfloat16(), cfg,
                          return_aux=False)
    assert float(zero) == 0.0


def test_init_moe_keeps_the_router_fp32():
    _, cfg = _cfgs(shared=2, dense=True)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, device=torch.device("cpu"),
                     dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["experts"]["gate"].dtype == torch.bfloat16
    assert p["experts"]["gate"].shape == (8, 16, 32)
    assert p["experts"]["down"].shape == (8, 32, 16)
    assert p["shared"]["up"]["w"].shape == (16, 64)


# ----------------------------------------------------------------- blocks
def _smoke(name, **over):
    jcfg = dataclasses.replace(jreduce(jget_config(name)), **over)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(name)), **over)
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b"])
def test_moe_block_matches_jax_in_prefill_and_decode(name):
    jcfg, cfg, jp, tp = _smoke(name)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["stack"]["layers"])
    tl = tp["stack"]["layers"][1]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    jy, (jk, jv), jaux = JT.moe_block_seq(jl, xj, jcfg, jnp.asarray(pos), 8, 8)
    ty, (tk, tv), taux = T.moe_block_seq(tl, xt, cfg, torch.from_numpy(pos),
                                         8, 8)
    assert_ulps(ty, jy, 2)
    assert_ulps(tk, jk, 1)
    assert_ulps(tv, jv, 1)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    Smax, clen = 32, 11
    ck = rng.normal(size=(2, Smax, cfg.n_kv_heads, cfg.resolved_head_dim))
    cv = rng.normal(size=ck.shape)
    u = rng.normal(size=(2, 1, cfg.d_model))
    jy, jck, _ = JT.moe_block_step(
        jl, jnp.asarray(u).astype(jnp.bfloat16),
        jnp.asarray(ck).astype(jnp.bfloat16),
        jnp.asarray(cv).astype(jnp.bfloat16), clen, jcfg)
    tck = torch.from_numpy(ck).bfloat16()
    ty, tck2, _ = T.moe_block_step(tl, torch.from_numpy(u).bfloat16(), tck,
                                   torch.from_numpy(cv).bfloat16(), clen, cfg)
    assert_ulps(ty, jy, 2)
    assert_ulps(tck2, jck, 1)


def test_bf16_init_gives_the_engine_the_same_weights():
    """`chip_smoke.py` builds deepseek-moe-16b's params in bf16 (fp32
    masters and the engine's bf16 copy do not fit 80 GB): the same draws,
    rounded once, so the engine holds the very values it holds for fp32
    masters, and the router stays fp32."""
    cfg = reduce_for_smoke(get_config("deepseek-moe-16b"))
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    scfg = ServeConfig(max_batch=1, max_seq=32)
    a = ServeEngine(cfg, M.init_params(cfg, 7, device="cpu"), scfg).params
    b = ServeEngine(cfg16, M.init_params(cfg16, 7, device="cpu"),
                    scfg).params
    la, lb = M.leaves(a), M.leaves(b)
    assert len(la) == len(lb)
    for ta, tb in zip(la, lb):
        assert ta.shape == tb.shape
        assert torch.equal(ta.float(), tb.float())
    assert b["stack"]["layers"][0]["moe"]["router"].dtype == torch.float32
    assert b["stack"]["layers"][0]["moe"]["experts"]["up"].dtype == \
        torch.bfloat16
    assert a["stack"]["layers"][0]["moe"]["experts"]["up"].dtype == \
        torch.bfloat16
    prompts = np.arange(12, dtype=np.int32).reshape(1, 12) % cfg.vocab_size
    np.testing.assert_array_equal(
        ServeEngine(cfg, M.init_params(cfg, 7, device="cpu"),
                    scfg).generate(prompts, new_tokens=4),
        ServeEngine(cfg16, M.init_params(cfg16, 7, device="cpu"),
                    scfg).generate(prompts, new_tokens=4))
