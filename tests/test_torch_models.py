"""Port LM modules (`repro_torch.models`) against the JAX package on the
same numpy inputs: layers, the attention and Mamba2 blocks with JAX's
weights carried across by `params_from_numpy`, and the port's parameter
counter. The flash and SSD plain versions are held against JAX in
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
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_numpy

BF16_ULP = 2.0 ** -7


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


# -------------------------------------------------------- parameter counts
PORTED_FULL = ["zamba2-2.7b", "mamba2-2.7b", "phi3-mini-3.8b", "smollm-360m",
               "qwen3-4b", "qwen1.5-0.5b", "musicgen-large"]


@pytest.mark.parametrize("name", PORTED_FULL)
def test_param_count_matches_jax_without_allocating(name):
    cfg = get_config(name)
    assert cfg.family in ("dense", "audio", "ssm", "hybrid")
    assert cfg.n_params() == jget_config(name).n_params()
    assert all(t.device.type == "meta" for t in M.leaves(M.param_shapes(cfg)))


def test_zamba2_full_width_param_count():
    assert get_config("zamba2-2.7b").n_params() == 2_422_670_240


@pytest.mark.parametrize("name", ["arctic-480b", "deepseek-moe-16b",
                                  "llama-3.2-vision-90b"])
def test_unported_families_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        get_config(name).n_params()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        M.init_params(reduce_for_smoke(get_config(name)), device="cpu")


def test_configs_and_smoke_reduction_match_jax():
    from repro.configs.base import list_configs as jlist
    from repro_torch.configs.base import list_configs
    assert list_configs() == jlist()
    for name in list_configs():
        assert vars(get_config(name)) == vars(jget_config(name))
        assert vars(reduce_for_smoke(get_config(name))) == vars(
            jreduce(jget_config(name)))
