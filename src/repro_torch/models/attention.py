"""GQA attention: flash (online softmax) for training and prefill, cached
decode. The port of the JAX package's `models/attention.py`.

Training and prefill go through `kernels/flash_attention/ops.py`: the
hand-written CUDA kernel on the card, on the CPU the plain version, which
is the JAX package's chunked oracle `_flash_fwd_impl` (re-exported here as
`flash_attention_plain`); with grad enabled the wrapper's autograd Function
adds the backward of `_flash_bwd_impl`. One card means no `model` axis, so the JAX
code's shard hints are dropped and the padded head count equals H.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, flash_attention_plain, reference_attention)
from repro_torch.models.layers import (COMPUTE_DTYPE, apply_rope,
                                       init_rmsnorm, normal, rms_norm)


def _head_proj_init(gen, d_model, n_heads, head_dim, bias, *, device, dtype):
    """Weights kept 3-D [d_model, H, head_dim], as in the JAX package."""
    w = (normal(gen, (d_model, n_heads, head_dim), device=device)
         / math.sqrt(d_model)).to(dtype)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((n_heads, head_dim), dtype=dtype, device=device)
    return p


def init_attention(gen, cfg, *, device, dtype=torch.float32):
    hd = cfg.resolved_head_dim
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": _head_proj_init(gen, cfg.d_model, cfg.n_heads, hd,
                              cfg.qkv_bias, **kw),
        "wk": _head_proj_init(gen, cfg.d_model, cfg.n_kv_heads, hd,
                              cfg.qkv_bias, **kw),
        "wv": _head_proj_init(gen, cfg.d_model, cfg.n_kv_heads, hd,
                              cfg.qkv_bias, **kw),
        "wo": {"w": (normal(gen, (cfg.n_heads, hd, cfg.d_model), device=device)
                     / math.sqrt(cfg.n_heads * hd)).to(dtype)},
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, **kw)
        p["k_norm"] = init_rmsnorm(hd, **kw)
    return p


def _head_proj(p, x):
    """x [B,S,d] -> [B,S,H,hd], bf16."""
    w = p["w"].to(COMPUTE_DTYPE)
    d, H, hd = w.shape
    y = torch.matmul(x.to(COMPUTE_DTYPE), w.reshape(d, H * hd))
    y = y.reshape(*x.shape[:-1], H, hd)
    if "b" in p:
        y = y + p["b"].to(COMPUTE_DTYPE)
    return y


def _out_proj(p, o):
    """o: [B,S,H,hd] -> [B,S,d], bf16 out."""
    w = p["w"].to(COMPUTE_DTYPE)
    H, hd, d = w.shape
    return torch.matmul(o.reshape(*o.shape[:-2], H * hd), w.reshape(H * hd, d))


def _project_q(p, x, cfg):
    q = _head_proj(p["wq"], x)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_qkv(p, x, kv_x, cfg, positions, kv_positions, *, rope=True):
    """q from x, k and v from kv_x (x itself for self-attention), with
    qk-norm, and RoPE unless `rope=False` (cross-attention)."""
    q = _project_q(p, x, cfg)
    k = _head_proj(p["wk"], kv_x)
    v = _head_proj(p["wv"], kv_x)
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(t, cfg):
    """[B,S,Hkv,D] -> [B,S,H,D], query head h reading kv head
    min(h // (H // Hkv), Hkv - 1) (the JAX package's `kv_map`). Where Hkv
    divides H that is each kv head repeated H // Hkv times, done as an
    expand and a reshape, whose backward is a sum (deterministic on the
    card, where the backward of `index_select` adds with atomics)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if H == Hkv:        # no grouping: the expansion would copy k and v
        return t
    B, S, _, D = t.shape
    if H % Hkv == 0:
        return t[:, :, :, None].expand(B, S, Hkv, H // Hkv, D).reshape(
            B, S, H, D)
    kv_map = torch.clamp(torch.arange(H, device=t.device) // (H // Hkv),
                         max=Hkv - 1)
    return t.index_select(2, kv_map)


def attention_block(p, x, *, cfg, positions, kv_x=None, kv_positions=None,
                    causal=True, rope=True, q_chunk=1024, kv_chunk=1024):
    """Full-sequence attention (prefill): causal self-attention, or, with
    `kv_x` (e.g. vision tokens), `causal=False` and `rope=False`,
    cross-attention. Returns (y, (k, v)).

    KV heads are expanded to the query heads before the flash core (the
    GQA expansion of the JAX package); the returned cache k/v stay in their
    compact [B,Skv,Hkv,hd] form. `q_chunk`/`kv_chunk` are the plain
    version's chunks (the CPU path); the kernel tiles by itself."""
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(p, x, kv_x, cfg, positions, kv_positions,
                           rope=rope)
    k_exp, v_exp = _expand_kv(k, cfg), _expand_kv(v, cfg)
    o = flash_ops.flash_attention(q, k_exp, v_exp, causal=causal,
                                  qc=q_chunk, kc=kv_chunk)
    y = _out_proj(p["wo"], o)
    return y, (k, v)


def _decode_core(p, q, k, v, *, cfg, valid=None):
    """One query token over k/v [B,Skv,Hkv,D] with GQA grouping: fp32
    scores and PV of the bf16 values, bf16 weights; `valid` [Skv] masks
    keys out. Returns the projected output [B,1,d]."""
    B, hd = q.shape[0], cfg.resolved_head_dim
    Hkv, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, 1, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                     k.to(COMPUTE_DTYPE).float()) / math.sqrt(hd)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE)
    o = torch.einsum("bhgqk,bkhd->bhgqd", w.float(),
                     v.to(COMPUTE_DTYPE).float()).to(COMPUTE_DTYPE)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, cfg.n_heads, hd)
    return _out_proj(p["wo"], o)


def decode_attention(p, x, cache_k, cache_v, cache_len: int, *, cfg):
    """One-token decode. x:[B,1,d]; cache_k/v:[B,Smax,Hkv,D]; cache_len an
    int. Writes the new k/v into the cache in place (the JAX package
    donates the cache and returns an updated copy). Returns
    (y, cache_k, cache_v)."""
    B, Smax = cache_k.shape[0], cache_k.shape[1]
    positions = torch.full((B, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, cfg, positions, positions)
    cache_k[:, cache_len:cache_len + 1] = k_new.to(cache_k.dtype)
    cache_v[:, cache_len:cache_len + 1] = v_new.to(cache_v.dtype)
    valid = torch.arange(Smax, device=x.device) <= cache_len
    y = _decode_core(p, q, cache_k, cache_v, cfg=cfg, valid=valid)
    return y, cache_k, cache_v


def decode_cross_attention(p, x, cross_k, cross_v, *, cfg):
    """One-token attention over a fixed (precomputed) KV set, no RoPE and
    no mask. x:[B,1,d]; cross_k/v:[B,Tv,Hkv,D]. Only q is projected: the
    JAX package also projects k and v of x and drops them."""
    return _decode_core(p, _project_q(p, x, cfg), cross_k, cross_v, cfg=cfg)
