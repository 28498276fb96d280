"""Port LM modules (`repro_torch.models`) against the JAX package on the
same numpy inputs: layers, the attention (self and cross) and Mamba2 blocks with JAX's
weights carried across by `params_from_numpy`, and the port's parameter
counters. The MoE FFN and block are held against JAX in
tests/test_torch_moe.py. The flash and SSD plain versions are held against JAX in
tests/test_torch_kernels.py.

JAX runs eagerly here, with its default flags. Tolerances are stated at
each comparison; "ulps" are bf16 ulps of the largest value compared
(2^-7 of it), since both packages round to bf16 at the same points and
differ only where an fp32 sum taken in another order rounds the other way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduce_for_smoke as jreduce
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

BF16_ULP = 2.0 ** -7
ALL_CONFIGS = ["arctic-480b", "deepseek-moe-16b", "llama-3.2-vision-90b",
               "mamba2-2.7b", "musicgen-large", "phi3-mini-3.8b",
               "qwen1.5-0.5b", "qwen3-4b", "smollm-360m", "zamba2-2.7b"]


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


def assert_ulps(got, ref, ulps=1.0):
    """|got - ref| <= ulps bf16 ulps of max |ref|, everywhere."""
    g, r = f32(got), f32(ref)
    assert g.shape == r.shape
    err, top = np.abs(g - r).max(), np.abs(r).max()
    assert err <= ulps * BF16_ULP * top, (err, top)


def bf16_pair(a):
    """The same bf16 values in JAX and in torch."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(np.asarray(a, np.float32)).bfloat16())


# -------------------------------------------------------------------- layers
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    xj, xt = bf16_pair(rng.normal(size=(2, 16, 128)))
    scale = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    assert_ulps(L.rms_norm({"scale": torch.from_numpy(scale)}, xt, 1e-5),
                JL.rms_norm({"scale": jnp.asarray(scale)}, xj, 1e-5))

    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    hj, ht = bf16_pair(rng.normal(size=(2, 16, 4, 32)))
    assert_ulps(L.apply_rope(ht, torch.from_numpy(pos), 1e4),
                JL.apply_rope(hj, jnp.asarray(pos), 1e4))

    ffn = {k: {"w": (rng.normal(size=shape) / 11).astype(np.float32)}
           for k, shape in (("gate", (128, 256)), ("up", (128, 256)),
                            ("down", (256, 128)))}
    assert_ulps(L.swiglu({k: {"w": torch.from_numpy(v["w"])}
                          for k, v in ffn.items()}, xt),
                JL.swiglu(jax.tree_util.tree_map(jnp.asarray, ffn), xj))

    table = (rng.normal(size=(512, 128)) * 0.02).astype(np.float32)
    ids = rng.integers(0, 512, (2, 16))
    emb_t = L.embed({"table": torch.from_numpy(table)}, torch.from_numpy(ids))
    emb_j = JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids))
    np.testing.assert_array_equal(f32(emb_t), f32(emb_j))   # a gather
    # fp32 products of bf16 values, summed in another order: fp32 rounding
    np.testing.assert_allclose(
        f32(L.unembed({"table": torch.from_numpy(table)}, xt)),
        f32(JL.unembed({"table": jnp.asarray(table)}, xj)),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- blocks
def _smoke(name, **over):
    jcfg = dataclasses.replace(jreduce(jget_config(name)), **over)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(name)), **over)
    # jitted: fp32 draws only, and both packages take the same arrays
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("name", ["qwen3-4b", "qwen1.5-0.5b"])
def test_attention_blocks_match_jax(name):
    _attention_block_matches_jax(name)


def test_grouped_attention_block_matches_jax():
    # every smoke config keeps 4 query and 4 kv heads: 2 kv heads take the
    # GQA expansion, which the ungrouped blocks above pass by
    _attention_block_matches_jax("qwen3-4b", n_kv_heads=2)


def _attention_block_matches_jax(name, **over):
    jcfg, cfg, jp, tp = _smoke(name, **over)
    ja = jax.tree_util.tree_map(lambda a: a[1], jp["stack"]["layers"])["attn"]
    ta = tp["stack"]["layers"][1]["attn"]
    rng = np.random.default_rng(1)
    xj, xt = bf16_pair(rng.normal(size=(2, 24, cfg.d_model)))
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    jy, (jk, jv) = JA.attention_block(ja, xj, cfg=jcfg,
                                      positions=jnp.asarray(pos),
                                      q_chunk=8, kv_chunk=8)
    ty, (tk, tv) = A.attention_block(ta, xt, cfg=cfg,
                                     positions=torch.from_numpy(pos),
                                     q_chunk=8, kv_chunk=8)
    assert_ulps(ty, jy)
    assert_ulps(tk, jk)
    assert_ulps(tv, jv)

    Smax, clen = 32, 11
    ck = (rng.normal(size=(2, Smax, cfg.n_kv_heads, 32))).astype(np.float32)
    cv = (rng.normal(size=(2, Smax, cfg.n_kv_heads, 32))).astype(np.float32)
    (ckj, ckt), (cvj, cvt) = bf16_pair(ck), bf16_pair(cv)
    uj, ut = bf16_pair(rng.normal(size=(2, 1, cfg.d_model)))
    jy, jck, jcv = JA.decode_attention(ja, uj, ckj, cvj, clen, cfg=jcfg)
    ty, tck, tcv = A.decode_attention(ta, ut, ckt, cvt, clen, cfg=cfg)
    assert_ulps(ty, jy)
    assert_ulps(tck, jck)
    assert_ulps(tcv, jcv)
    assert tck is ckt                      # the port updates in place


def test_mamba2_blocks_match_jax():
    jcfg, cfg, jp, tp = _smoke("zamba2-2.7b")
    jm = jax.tree_util.tree_map(lambda a: a[1, 0], jp["stack"]["units"])
    jm, tm = jm["mamba"], tp["stack"]["units"][1][0]["mamba"]
    rng = np.random.default_rng(2)
    uj, ut = bf16_pair(rng.normal(size=(2, 32, cfg.d_model)))
    jy, (jst, jtails) = JS.mamba2_seq(jm, uj, cfg=jcfg, chunk=16)
    ty, (tst, ttails) = S.mamba2_seq(tm, ut, cfg=cfg, chunk=16)
    assert_ulps(ty, jy)
    assert_ulps(tst, jst)
    for a, b in zip(ttails, jtails):
        assert_ulps(a, b)

    vj, vt = bf16_pair(rng.normal(size=(2, 1, cfg.d_model)))
    jy, (jst2, jtails2) = JS.mamba2_step(jm, vj, jst, jtails, cfg=jcfg)
    ty, (tst2, ttails2) = S.mamba2_step(tm, vt, tst, ttails, cfg=cfg)
    assert_ulps(ty, jy)
    assert_ulps(tst2, jst2)
    for a, b in zip(ttails2, jtails2):
        assert_ulps(a, b)


# -------------------------------------------------------- cross-attention
def _vlm_smoke_with_open_gates():
    """llama-3.2-vision-90b's smoke reduction, with the cross blocks' tanh
    gates at 1.0 on both sides (they initialise at 0, which makes a cross
    block a no-op)."""
    jcfg, cfg, jp, tp = _smoke("llama-3.2-vision-90b")
    for name in ("attn_gate", "ffn_gate"):
        jp["stack"]["cross"][name] = jnp.ones_like(jp["stack"]["cross"][name])
        for block in tp["stack"]["cross"]:
            block[name] = torch.ones_like(block[name])
    return jcfg, cfg, jp, tp


def test_cross_attention_matches_jax():
    jcfg, cfg, jp, tp = _vlm_smoke_with_open_gates()
    ja = jax.tree_util.tree_map(lambda a: a[1], jp["stack"]["cross"])
    tb = tp["stack"]["cross"][1]
    rng = np.random.default_rng(3)
    Sq, Tv = 24, cfg.n_vision_tokens
    xj, xt = bf16_pair(rng.normal(size=(2, Sq, cfg.d_model)))
    vj, vt = bf16_pair(rng.normal(size=(2, Tv, cfg.d_model)))
    pos = np.tile(np.arange(Sq, dtype=np.int32), (2, 1))
    zeros = np.zeros((2, Tv), np.int32)
    jy, (jk, jv) = JA.attention_block(
        ja["cross_attn"], xj, cfg=jcfg, positions=jnp.asarray(pos), kv_x=vj,
        kv_positions=jnp.asarray(zeros), causal=False, rope=False,
        q_chunk=8, kv_chunk=8)
    ty, (tk, tv) = A.attention_block(
        tb["cross_attn"], xt, cfg=cfg, positions=torch.from_numpy(pos),
        kv_x=vt, kv_positions=torch.from_numpy(zeros), causal=False,
        rope=False, q_chunk=8, kv_chunk=8)
    assert tk.shape == (2, Tv, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert_ulps(ty, jy)
    assert_ulps(tk, jk)
    assert_ulps(tv, jv)

    uj, ut = bf16_pair(rng.normal(size=(2, 1, cfg.d_model)))
    jy = JA.decode_cross_attention(ja["cross_attn"], uj, jk, jv, Tv, cfg=jcfg)
    ty = A.decode_cross_attention(tb["cross_attn"], ut, tk, tv, cfg=cfg)
    assert_ulps(ty, jy)

    # the whole gated block, prefill and decode
    jx, (jk, jv) = JT.cross_block_seq(ja, xj, vj, jcfg, jnp.asarray(pos))
    tx, (tk, tv) = T.cross_block_seq(tb, xt, vt, cfg, torch.from_numpy(pos))
    assert_ulps(tx, jx, 2)
    assert_ulps(tk, jk)
    jx = JT.cross_block_step(ja, uj, jk, jv, jcfg)
    tx = T.cross_block_step(tb, ut, tk, tv, cfg)
    assert_ulps(tx, jx, 2)
    assert float((tx.float() - ut.float()).abs().max()) > 1e-2   # not a no-op


# -------------------------------------------------------- parameter counts
@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_param_count_matches_jax_without_allocating(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert (cfg.n_active_params() < cfg.n_params()) == (cfg.family == "moe")
    assert all(t.device.type == "meta" for t in M.leaves(M.param_shapes(cfg)))


def test_zamba2_full_width_param_count():
    assert get_config("zamba2-2.7b").n_params() == 2_422_670_240


def test_moe_and_vlm_full_width_param_counts():
    ds = get_config("deepseek-moe-16b")
    assert (ds.n_params(), ds.n_active_params()) == (16_375_728_128,
                                                     2_828_650_496)
    arctic = get_config("arctic-480b")
    assert (arctic.n_params(), arctic.n_active_params()) == (
        476_850_275_328, 15_584_314_368)
    # the depth chip_smoke.py serves: two units of 4 self + 1 cross layer
    llama10 = dataclasses.replace(get_config("llama-3.2-vision-90b"),
                                  n_layers=10)
    assert llama10.n_params() == 10_657_898_500


def test_every_config_builds_and_runs_a_step():
    for name in ALL_CONFIGS:
        cfg = reduce_for_smoke(get_config(name))
        params = M.init_params(cfg, 0, device="cpu")
        assert sum(t.numel() for t in M.leaves(params)) == cfg.n_params()
        cache = M.init_decode_cache(cfg, 1, 8, device="cpu")
        with torch.inference_mode():
            logits, _ = M.decode_step(params, cfg,
                                      torch.zeros((1, 1), dtype=torch.long),
                                      cache, 0)
        assert logits.shape == (1, 1, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())


def test_configs_and_smoke_reduction_match_jax():
    from repro.configs.base import list_configs as jlist
    from repro_torch.configs.base import list_configs
    assert list_configs() == jlist()
    for name in list_configs():
        assert vars(get_config(name)) == vars(jget_config(name))
        assert vars(reduce_for_smoke(get_config(name))) == vars(
            jreduce(jget_config(name)))
