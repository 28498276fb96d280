"""Per-family layer stacks: the port of the JAX package's
`models/transformer.py` for every family (dense and audio, moe, ssm,
hybrid, vlm).

Every family exposes:
  init(gen, cfg, device)                   -> params: per-layer dicts in lists
  seq(p, x, cfg, ...)                      -> (x, aux, cache)   # prefill
  step(p, x, cache, cache_len, cfg)        -> (x, cache)        # decode
  cache_spec(cfg, B, S)                    -> {name: TensorSpec}
The JAX package scans over stacked params; here the layers are a Python
loop over lists (`params_from_numpy` unstacks), while the decode cache keeps
the JAX package's stacked layout ([L, ...] or [U, I, ...]), so the two
caches compare leaf by leaf. Decode writes the cache in place.

`seq(..., remat=True)` checkpoints the bodies the JAX package wraps in
`_maybe_remat` (each layer; for the hybrid and vlm families each unit
around its own checkpointed inner layers) with `torch.utils.checkpoint`:
their activations are recomputed in the backward instead of kept.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.meshctx import (assign, current_mesh, dtensor_scope,
                                 reduce_grads_once)
from repro_torch.models import ssm
from repro_torch.models.attention import (attention_block, decode_attention,
                                          decode_cross_attention,
                                          init_attention)
from repro_torch.models.layers import (COMPUTE_DTYPE, init_rmsnorm,
                                       init_swiglu, rms_norm, swiglu)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.optim.tree import tree_leaves, tree_unflatten


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


# ================================================================= moe block
def init_moe_block(gen, cfg, *, device, dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, **kw),
        "attn": init_attention(gen, cfg, **kw),
        "ffn_norm": init_rmsnorm(cfg.d_model, **kw),
        "moe": init_moe(gen, cfg, **kw),
    }


def moe_block_seq(p, x, cfg, positions, q_chunk, kv_chunk):
    h, kv = attention_block(p["attn"],
                            rms_norm(p["attn_norm"], x, cfg.norm_eps),
                            cfg=cfg, positions=positions,
                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + h
    y, aux = moe_ffn(p["moe"], rms_norm(p["ffn_norm"], x, cfg.norm_eps), cfg)
    return x + y, kv, aux


def moe_block_step(p, x, ck, cv, cache_len, cfg):
    h, ck, cv = decode_attention(p["attn"],
                                 rms_norm(p["attn_norm"], x, cfg.norm_eps),
                                 ck, cv, cache_len, cfg=cfg)
    x = x + h
    y, _ = moe_ffn(p["moe"], rms_norm(p["ffn_norm"], x, cfg.norm_eps), cfg,
                   return_aux=False)
    return x + y, ck, cv


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
    `idx` of the stacked cache; writes them back in place (on a DTensor
    cache, each rank its own shard)."""
    st = cache["ssm"][idx]
    tails = tuple(t[idx] for t in cache["conv"])
    x, st_new, tails_new = ssm_block_step(p, x, st, tails, cfg)
    assign(st, st_new)
    for dst, src in zip(tails, tails_new):
        assign(dst, src)
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


def _stack_kv(ks, vs):
    return {"k": torch.stack(ks).to(COMPUTE_DTYPE),
            "v": torch.stack(vs).to(COMPUTE_DTYPE)}


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _maybe_remat(fn, remat: bool):
    """`fn`, or `fn` under activation checkpointing (the JAX package's
    `jax.checkpoint`): only its inputs are kept, and its forward runs again
    in the backward, in the mesh scope it first ran in (the backward may
    run on another thread, where no mesh is active). Either way the
    gradients of the params it is given (its dict and list arguments) are
    reduced together when its backward ends (`meshctx.reduce_grads_once`:
    one layer's weight gradients, as XLA reduces them a scan step)."""
    def params_once(args):
        return tuple(tree_unflatten(a, reduce_grads_once(tree_leaves(a)))
                     if isinstance(a, (dict, list)) else a for a in args)

    if not remat:
        return lambda *args: fn(*params_once(args))

    def run(*args):
        mesh = current_mesh()

        def scoped(*a):
            with dtensor_scope(mesh):
                return fn(*a)
        return checkpoint(scoped if mesh is not None else fn,
                          *params_once(args), use_reentrant=False)
    return run


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
    def seq(p, x, cfg, *, positions, remat=False, with_cache=False,
            q_chunk=1024, kv_chunk=1024, **_):
        ks, vs = [], []
        body = _maybe_remat(dense_block_seq, remat)
        for layer_p in p["layers"]:
            x, (k, v) = body(layer_p, x, cfg, positions, q_chunk, kv_chunk)
            if with_cache:
                ks.append(k)
                vs.append(v)
        return x, _zero_aux(x), _stack_kv(ks, vs) if with_cache else None

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
# Family: moe  (optional dense first layers — deepseek-moe)
# ===========================================================================
class MoeStack:
    @staticmethod
    def init(gen, cfg, *, device, dtype=torch.float32):
        n_moe = cfg.n_layers - cfg.first_dense_layers
        p = {"layers": [init_moe_block(gen, cfg, device=device, dtype=dtype)
                        for _ in range(n_moe)]}
        if cfg.first_dense_layers:
            p["first"] = [init_dense_block(gen, cfg, device=device,
                                           d_ff=cfg.dense_d_ff, dtype=dtype)
                          for _ in range(cfg.first_dense_layers)]
        return p

    @staticmethod
    def seq(p, x, cfg, *, positions, remat=False, with_cache=False,
            q_chunk=1024, kv_chunk=1024, **_):
        first, moe = ([], []), ([], [])
        fbody = _maybe_remat(dense_block_seq, remat)
        body = _maybe_remat(moe_block_seq, remat)
        for layer_p in p.get("first", ()):
            x, kv = fbody(layer_p, x, cfg, positions, q_chunk, kv_chunk)
            if with_cache:
                first[0].append(kv[0])
                first[1].append(kv[1])
        aux = _zero_aux(x)
        for layer_p in p["layers"]:
            x, kv, a = body(layer_p, x, cfg, positions, q_chunk, kv_chunk)
            aux = aux + a
            if with_cache:
                moe[0].append(kv[0])
                moe[1].append(kv[1])
        cache = None
        if with_cache:
            cache = {"moe": _stack_kv(*moe)}
            if first[0]:
                cache["first"] = _stack_kv(*first)
        return x, aux, cache

    @staticmethod
    def step(p, x, cache, cache_len, cfg, **_):
        for i, layer_p in enumerate(p.get("first", ())):
            x, _, _ = dense_block_step(layer_p, x, cache["first"]["k"][i],
                                       cache["first"]["v"][i], cache_len, cfg)
        for i, layer_p in enumerate(p["layers"]):
            x, _, _ = moe_block_step(layer_p, x, cache["moe"]["k"][i],
                                     cache["moe"]["v"][i], cache_len, cfg)
        return x, cache

    @staticmethod
    def cache_spec(cfg, B, S):
        spec = {"moe": _kv_cache_spec(
            (cfg.n_layers - cfg.first_dense_layers,), cfg, B, S)}
        if cfg.first_dense_layers:
            spec["first"] = _kv_cache_spec((cfg.first_dense_layers,), cfg, B,
                                           S)
        return spec


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
    def seq(p, x, cfg, *, remat=False, with_cache=False, ssd_chunk=128, **_):
        states, tails = [], []
        body = _maybe_remat(ssm_block_seq, remat)
        for layer_p in p["layers"]:
            x, st, tl = body(layer_p, x, cfg, ssd_chunk)
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
    def seq(p, x, cfg, *, positions, remat=False, with_cache=False,
            q_chunk=1024, kv_chunk=1024, ssd_chunk=128, **_):
        shared = p["shared"]
        inner = _maybe_remat(ssm_block_seq, remat)

        def unit(unit_p, x):
            # nested remat: a unit's backward holds one Mamba2 layer at a
            # time
            states, tails = [], []
            for lp in unit_p:
                x, st, tl = inner(lp, x, cfg, ssd_chunk)
                states.append(st)
                tails.append(tl)
            x, kv = dense_block_seq(shared, x, cfg, positions, q_chunk,
                                    kv_chunk)
            return x, states, tails, kv

        units, ks, vs = [], [], []
        for unit_p in p["units"]:
            x, states, tails, (k, v) = _maybe_remat(unit, remat)(unit_p, x)
            if with_cache:
                units.append(_stack_ssm_caches(states, tails))
                ks.append(k)
                vs.append(v)
        cache = None
        if with_cache:
            cache = {"ssm": torch.stack([u["ssm"] for u in units]),
                     "conv": tuple(torch.stack([u["conv"][j] for u in units])
                                   for j in range(3)),
                     **_stack_kv(ks, vs)}
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


# ===========================================================================
# Family: vlm (llama-3.2-vision) — units of (interval-1) self layers + 1
# cross-attention layer over precomputed vision-patch embeddings.
# ===========================================================================
def init_cross_block(gen, cfg, *, device, dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    return {
        "cross_norm": init_rmsnorm(cfg.d_model, **kw),
        "cross_attn": init_attention(gen, cfg, **kw),
        "attn_gate": torch.zeros((1,), **kw),
        "ffn_norm": init_rmsnorm(cfg.d_model, **kw),
        "ffn": init_swiglu(gen, cfg.d_model, cfg.d_ff, **kw),
        "ffn_gate": torch.zeros((1,), **kw),
    }


def _gated(gate, h):
    """tanh(gate) in fp32, rounded to bf16, times h (bf16)."""
    return torch.tanh(gate.float()).to(COMPUTE_DTYPE) * h


def cross_block_seq(p, x, vision, cfg, positions):
    """Cross-attention over `vision` [B,Tv,d] (no RoPE, no mask), then the
    gated FFN. The plain version's chunks are the JAX package's own."""
    zeros = torch.zeros(vision.shape[:2], dtype=torch.int32,
                        device=vision.device)
    h, kv = attention_block(p["cross_attn"],
                            rms_norm(p["cross_norm"], x, cfg.norm_eps),
                            cfg=cfg, positions=positions, kv_x=vision,
                            kv_positions=zeros, causal=False, rope=False,
                            q_chunk=1024, kv_chunk=min(1024, vision.shape[1]))
    x = x + _gated(p["attn_gate"], h)
    f = swiglu(p["ffn"], rms_norm(p["ffn_norm"], x, cfg.norm_eps))
    return x + _gated(p["ffn_gate"], f), kv


def cross_block_step(p, x, cross_k, cross_v, cfg):
    h = decode_cross_attention(p["cross_attn"],
                               rms_norm(p["cross_norm"], x, cfg.norm_eps),
                               cross_k, cross_v, cfg=cfg)
    x = x + _gated(p["attn_gate"], h)
    f = swiglu(p["ffn"], rms_norm(p["ffn_norm"], x, cfg.norm_eps))
    return x + _gated(p["ffn_gate"], f)


class VlmStack:
    @staticmethod
    def init(gen, cfg, *, device, dtype=torch.float32):
        I = cfg.cross_attn_interval
        U = cfg.n_layers // I
        units = [[init_dense_block(gen, cfg, device=device, dtype=dtype)
                  for _ in range(I - 1)] for _ in range(U)]
        cross = [init_cross_block(gen, cfg, device=device, dtype=dtype)
                 for _ in range(U)]
        return {"self_units": units, "cross": cross}      # [U][I-1], [U]

    @staticmethod
    def seq(p, x, cfg, *, positions, vision_embeds, remat=False,
            with_cache=False, q_chunk=1024, kv_chunk=1024, **_):
        inner = _maybe_remat(dense_block_seq, remat)

        def unit(unit_p, cross_p, x):
            # nested remat: a unit's backward holds one layer's internals
            kvs = []
            for lp in unit_p:
                x, kv = inner(lp, x, cfg, positions, q_chunk, kv_chunk)
                kvs.append(kv)
            x, ckv = cross_block_seq(cross_p, x, vision_embeds, cfg,
                                     positions)
            return x, kvs, ckv

        ks, vs, cks, cvs = [], [], [], []
        for unit_p, cross_p in zip(p["self_units"], p["cross"]):
            x, kvs, (ck, cv) = _maybe_remat(unit, remat)(unit_p, cross_p, x)
            if with_cache:
                ks += [k for k, _ in kvs]
                vs += [v for _, v in kvs]
                cks.append(ck)
                cvs.append(cv)
        cache = None
        if with_cache:
            U = len(p["cross"])
            self_kv = _stack_kv(ks, vs)
            cross = _stack_kv(cks, cvs)
            cache = {k: t.reshape(U, -1, *t.shape[1:])
                     for k, t in self_kv.items()}
            cache.update(cross_k=cross["k"], cross_v=cross["v"])
        return x, _zero_aux(x), cache

    @staticmethod
    def step(p, x, cache, cache_len, cfg, **_):
        for u, (unit_p, cross_p) in enumerate(zip(p["self_units"],
                                                  p["cross"])):
            for i, lp in enumerate(unit_p):
                x, _, _ = dense_block_step(lp, x, cache["k"][u, i],
                                           cache["v"][u, i], cache_len, cfg)
            x = cross_block_step(cross_p, x, cache["cross_k"][u],
                                 cache["cross_v"][u], cfg)
        return x, cache

    @staticmethod
    def cache_spec(cfg, B, S):
        I = cfg.cross_attn_interval
        U = cfg.n_layers // I
        cross = _kv_cache_spec((U,), cfg, B, cfg.n_vision_tokens)
        return {**_kv_cache_spec((U, I - 1), cfg, B, S),
                "cross_k": cross["k"], "cross_v": cross["v"]}


STACKS = {
    "dense": DenseStack,
    "audio": DenseStack,
    "moe": MoeStack,
    "ssm": SsmStack,
    "hybrid": HybridStack,
    "vlm": VlmStack,
}


def stack_for(cfg):
    """The stack class of `cfg.family`."""
    return STACKS[cfg.family]
