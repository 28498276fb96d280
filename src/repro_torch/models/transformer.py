"""Per-family layer stacks: the port of the JAX package's
`models/transformer.py` for the dense (and audio), ssm and hybrid families.

Every family exposes:
  init(gen, cfg, device)                   -> params: per-layer dicts in lists
  seq(p, x, cfg, ...)                      -> (x, aux, cache)   # prefill
  step(p, x, cache, cache_len, cfg)        -> (x, cache)        # decode
  cache_spec(cfg, B, S)                    -> {name: TensorSpec}
The JAX package scans over stacked params; here the layers are a Python
loop over lists (`params_from_numpy` unstacks), while the decode cache keeps
the JAX package's stacked layout ([L, ...] or [U, I, ...]), so the two
caches compare leaf by leaf. Decode writes the cache in place.

`MoeStack` and `VlmStack` wait for `models/moe.py` and the cross-attention
block (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import ssm
from repro_torch.models.attention import (attention_block, decode_attention,
                                          init_attention)
from repro_torch.models.layers import (COMPUTE_DTYPE, init_rmsnorm,
                                       init_swiglu, rms_norm, swiglu)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple
    dtype: torch.dtype


# =============================================================== dense block
def init_dense_block(gen, cfg, *, device, d_ff=None, dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, **kw),
        "attn": init_attention(gen, cfg, **kw),
        "ffn_norm": init_rmsnorm(cfg.d_model, **kw),
        "ffn": init_swiglu(gen, cfg.d_model, d_ff or cfg.d_ff, **kw),
    }


def dense_block_seq(p, x, cfg, positions, q_chunk, kv_chunk):
    h, kv = attention_block(p["attn"],
                            rms_norm(p["attn_norm"], x, cfg.norm_eps),
                            cfg=cfg, positions=positions,
                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + h
    x = x + swiglu(p["ffn"], rms_norm(p["ffn_norm"], x, cfg.norm_eps))
    return x, kv


def dense_block_step(p, x, ck, cv, cache_len, cfg):
    h, ck, cv = decode_attention(p["attn"],
                                 rms_norm(p["attn_norm"], x, cfg.norm_eps),
                                 ck, cv, cache_len, cfg=cfg)
    x = x + h
    x = x + swiglu(p["ffn"], rms_norm(p["ffn_norm"], x, cfg.norm_eps))
    return x, ck, cv


# ================================================================ ssm block
def init_ssm_block(gen, cfg, *, device, dtype=torch.float32):
    return {"norm": init_rmsnorm(cfg.d_model, device=device, dtype=dtype),
            "mamba": ssm.init_mamba2(gen, cfg, device=device, dtype=dtype)}


def ssm_block_seq(p, x, cfg, ssd_chunk=128):
    """-> (x, state, conv tails)"""
    y, (st, tails) = ssm.mamba2_seq(p["mamba"],
                                    rms_norm(p["norm"], x, cfg.norm_eps),
                                    cfg=cfg, chunk=ssd_chunk)
    return x + y, st, tails


def ssm_block_step(p, x, st, tails, cfg):
    y, (st, tails) = ssm.mamba2_step(p["mamba"],
                                     rms_norm(p["norm"], x, cfg.norm_eps),
                                     st, tails, cfg=cfg)
    return x + y, st, tails


def _ssm_step_into(p, x, cache, idx, cfg):
    """One decode step of an ssm block whose state and conv tails sit at
    `idx` of the stacked cache; writes them back in place."""
    st = cache["ssm"][idx]
    tails = tuple(t[idx] for t in cache["conv"])
    x, st_new, tails_new = ssm_block_step(p, x, st, tails, cfg)
    st.copy_(st_new)
    for dst, src in zip(tails, tails_new):
        dst.copy_(src)
    return x


def _stack_ssm_caches(states, tails):
    return {"ssm": torch.stack(states),
            "conv": tuple(torch.stack([t[j] for t in tails]) for j in range(3))}


def _ssm_cache_spec(lead, cfg, B):
    H, P, N = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    K = cfg.ssm_conv
    return {"ssm": TensorSpec((*lead, B, H, P, N), COMPUTE_DTYPE),
            "conv": (TensorSpec((*lead, B, K - 1, cfg.d_inner), COMPUTE_DTYPE),
                     TensorSpec((*lead, B, K - 1, N), COMPUTE_DTYPE),
                     TensorSpec((*lead, B, K - 1, N), COMPUTE_DTYPE))}


def _kv_cache_spec(lead, cfg, B, S):
    shape = (*lead, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": TensorSpec(shape, COMPUTE_DTYPE),
            "v": TensorSpec(shape, COMPUTE_DTYPE)}


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ===========================================================================
# Family: dense / audio  (uniform stack of dense blocks)
# ===========================================================================
class DenseStack:
    @staticmethod
    def init(gen, cfg, *, device, dtype=torch.float32):
        return {"layers": [init_dense_block(gen, cfg, device=device,
                                            dtype=dtype)
                           for _ in range(cfg.n_layers)]}

    @staticmethod
    def seq(p, x, cfg, *, positions, with_cache=False, q_chunk=1024,
            kv_chunk=1024, **_):
        ks, vs = [], []
        for layer_p in p["layers"]:
            x, (k, v) = dense_block_seq(layer_p, x, cfg, positions, q_chunk,
                                        kv_chunk)
            if with_cache:
                ks.append(k)
                vs.append(v)
        cache = None
        if with_cache:
            cache = {"k": torch.stack(ks).to(COMPUTE_DTYPE),
                     "v": torch.stack(vs).to(COMPUTE_DTYPE)}
        return x, _zero_aux(x), cache

    @staticmethod
    def step(p, x, cache, cache_len, cfg, **_):
        for i, layer_p in enumerate(p["layers"]):
            x, _, _ = dense_block_step(layer_p, x, cache["k"][i],
                                       cache["v"][i], cache_len, cfg)
        return x, cache

    @staticmethod
    def cache_spec(cfg, B, S):
        return _kv_cache_spec((cfg.n_layers,), cfg, B, S)


# ===========================================================================
# Family: ssm  (mamba2, attention-free)
# ===========================================================================
class SsmStack:
    @staticmethod
    def init(gen, cfg, *, device, dtype=torch.float32):
        return {"layers": [init_ssm_block(gen, cfg, device=device,
                                          dtype=dtype)
                           for _ in range(cfg.n_layers)]}

    @staticmethod
    def seq(p, x, cfg, *, with_cache=False, ssd_chunk=128, **_):
        states, tails = [], []
        for layer_p in p["layers"]:
            x, st, tl = ssm_block_seq(layer_p, x, cfg, ssd_chunk)
            if with_cache:
                states.append(st)
                tails.append(tl)
        cache = _stack_ssm_caches(states, tails) if with_cache else None
        return x, _zero_aux(x), cache

    @staticmethod
    def step(p, x, cache, cache_len, cfg, **_):
        for i, layer_p in enumerate(p["layers"]):
            x = _ssm_step_into(layer_p, x, cache, i, cfg)
        return x, cache

    @staticmethod
    def cache_spec(cfg, B, S):
        return _ssm_cache_spec((cfg.n_layers,), cfg, B)


# ===========================================================================
# Family: hybrid (zamba2) — mamba2 backbone + ONE shared attn/FFN block
# applied after every `shared_attn_interval` layers.
# ===========================================================================
class HybridStack:
    @staticmethod
    def init(gen, cfg, *, device, dtype=torch.float32):
        I = cfg.shared_attn_interval
        U = cfg.n_layers // I
        units = [[init_ssm_block(gen, cfg, device=device, dtype=dtype)
                  for _ in range(I)] for _ in range(U)]
        return {"units": units,                                # [U][I]
                "shared": init_dense_block(gen, cfg, device=device,
                                           dtype=dtype)}

    @staticmethod
    def seq(p, x, cfg, *, positions, with_cache=False, q_chunk=1024,
            kv_chunk=1024, ssd_chunk=128, **_):
        shared = p["shared"]
        units, ks, vs = [], [], []
        for unit_p in p["units"]:
            states, tails = [], []
            for lp in unit_p:
                x, st, tl = ssm_block_seq(lp, x, cfg, ssd_chunk)
                if with_cache:
                    states.append(st)
                    tails.append(tl)
            x, (k, v) = dense_block_seq(shared, x, cfg, positions, q_chunk,
                                        kv_chunk)
            if with_cache:
                units.append(_stack_ssm_caches(states, tails))
                ks.append(k)
                vs.append(v)
        cache = None
        if with_cache:
            cache = {"ssm": torch.stack([u["ssm"] for u in units]),
                     "conv": tuple(torch.stack([u["conv"][j] for u in units])
                                   for j in range(3)),
                     "k": torch.stack(ks).to(COMPUTE_DTYPE),
                     "v": torch.stack(vs).to(COMPUTE_DTYPE)}
        return x, _zero_aux(x), cache

    @staticmethod
    def step(p, x, cache, cache_len, cfg, **_):
        shared = p["shared"]
        for u, unit_p in enumerate(p["units"]):
            for i, lp in enumerate(unit_p):
                x = _ssm_step_into(lp, x, cache, (u, i), cfg)
            x, _, _ = dense_block_step(shared, x, cache["k"][u],
                                       cache["v"][u], cache_len, cfg)
        return x, cache

    @staticmethod
    def cache_spec(cfg, B, S):
        I = cfg.shared_attn_interval
        U = cfg.n_layers // I
        return {**_ssm_cache_spec((U, I), cfg, B),
                **_kv_cache_spec((U,), cfg, B, S)}


STACKS = {
    "dense": DenseStack,
    "audio": DenseStack,
    "ssm": SsmStack,
    "hybrid": HybridStack,
}

#: families whose stack is not ported yet, and the ROADMAP.md item that
#: ports each
NOT_PORTED = {
    "moe": "ROADMAP.md Queue 1, item 1 (models/moe.py and MoeStack)",
    "vlm": "ROADMAP.md Queue 1, item 2 (VlmStack and the cross-attention "
           "block)",
}


def stack_for(cfg):
    """The stack class of `cfg.family`; raises NotImplementedError for a
    family that is not ported yet."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to PyTorch "
            f"yet: {NOT_PORTED[cfg.family]}")
    return STACKS[cfg.family]
