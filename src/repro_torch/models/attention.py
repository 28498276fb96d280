"""GQA attention: flash (online softmax) for training and prefill, cached
decode. The port of the JAX package's `models/attention.py`.

Training and prefill go through `kernels/flash_attention/ops.py`: the
hand-written CUDA kernel on the card, on the CPU the plain version, which
is the JAX package's chunked oracle `_flash_fwd_impl` (re-exported here as
`flash_attention_plain`); with grad enabled the wrapper's autograd Function
adds the backward of `_flash_bwd_impl`.

On DTensors the reference's shard hints hold: q, k and v are pinned to
the batch axes and the heads or head_dim layout of `_attn_axes`, and the
flash core runs under `local_map` on each rank's batch and heads, laid out
(BATCH, None, "model", None). With a `model` axis the q-heads are padded
with zeros to a multiple of its size and k and v expanded through
`kv_map`, as the reference pads them; without one the padded head count
equals H and k and v are expanded as on one device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, flash_attention_plain, reference_attention)
from repro_torch.meshctx import (BATCH, assign, axis_size, is_dtensor,
                                local_map, reduce_grad, shard_hint)
from repro_torch.models.layers import (COMPUTE_DTYPE, apply_rope,
                                       init_rmsnorm, normal, rms_norm)


#: the batch axis of a decode cache (`launch.sharding.cache_pspec_tree`)
FSDP = "data"


def _attn_axes(cfg):
    """((q_heads, q_hd), (kv_heads, kv_hd)) hint axes: the layout of
    `launch.sharding.attn_layouts` against the active mesh."""
    tp = axis_size("model")
    if tp <= 1 or not cfg.n_heads:
        return (None, None), (None, None)
    hd_ok = cfg.resolved_head_dim % tp == 0
    if cfg.n_heads % tp == 0:
        q = ("model", None)
        kv = ("model", None) if cfg.n_kv_heads % tp == 0 else (None, None)
        return q, kv
    if hd_ok:
        return (None, "model"), (None, "model")
    return (None, None), (None, None)


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


def _head_proj(p, x, heads=None):
    """x [B,S,d] -> [B,S,H,hd], bf16. On DTensors the product is local to
    each rank's batch rows and its heads (over `heads`, the weight's H
    layout), with the weight's `d_model` and head_dim gathered whole:
    qk-norm and RoPE read whole head_dims."""
    if is_dtensor(x) or is_dtensor(p["w"]):
        args = (x, p["w"], p["b"]) if "b" in p else (x, p["w"])
        specs = ((BATCH, None, None), (None, heads, None),
                 (heads, None))[:len(args)]
        w = p["w"]
        return local_map(
            lambda x_, w_, *b_: _head_proj({"w": w_, **(
                {"b": b_[0]} if b_ else {})}, x_),
            args, specs, ((BATCH, None, heads, None),),
            ((x.shape[0], x.shape[1], w.shape[1], w.shape[2]),))
    w = p["w"].to(COMPUTE_DTYPE)
    d, H, hd = w.shape
    y = torch.matmul(x.to(COMPUTE_DTYPE), w.reshape(d, H * hd))
    y = y.reshape(*x.shape[:-1], H, hd)
    if "b" in p:
        y = y + p["b"].to(COMPUTE_DTYPE)
    return y


def _out_proj(p, o, axes=(None, None)):
    """o: [B,S,H,hd] -> [B,S,d], bf16 out. On DTensors the product is local
    to each rank's batch rows and its slice of the heads or head_dim
    (`axes`), its partial sum all-reduced over `model` where that is
    split."""
    if is_dtensor(o) or is_dtensor(p["w"]):
        h, k = axes
        return local_map(
            lambda o_, w_: _out_proj({"w": w_}, o_), (o, p["w"]),
            ((BATCH, None, h, k), (h, k, None)), ((BATCH, None, None),),
            ((o.shape[0], o.shape[1], p["w"].shape[2]),),
            partial=("model",) if "model" in axes else ())
    w = p["w"].to(COMPUTE_DTYPE)
    H, hd, d = w.shape
    return torch.matmul(o.reshape(*o.shape[:-2], H * hd), w.reshape(H * hd, d))


def _project_q(p, x, cfg):
    q = _head_proj(p["wq"], x, _attn_axes(cfg)[0][0])
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_qkv(p, x, kv_x, cfg, positions, kv_positions, *, rope=True):
    """q from x, k and v from kv_x (x itself for self-attention), with
    qk-norm, and RoPE unless `rope=False` (cross-attention)."""
    q = _project_q(p, x, cfg)
    kv_axes = _attn_axes(cfg)[1]
    k = _head_proj(p["wk"], kv_x, kv_axes[0])
    v = _head_proj(p["wv"], kv_x, kv_axes[0])
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    # pin the batch and head layout, as the reference does
    (qh, qd), (kh, kd) = _attn_axes(cfg)
    q = shard_hint(q, BATCH, None, qh, qd, site="attn.q")
    k = shard_hint(k, BATCH, None, kh, kd, site="attn.k")
    v = shard_hint(v, BATCH, None, kh, kd, site="attn.v")
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


def _take_heads(t, H: int, Hkv: int, Hp: int):
    """[B,S,Hkv,D] -> [B,S,Hp,D], head h reading kv head
    kv_map[h] = min(h // (H // Hkv), Hkv - 1) (the reference's `take`).
    kv_map does not decrease, so this is each kv head broadcast over its
    run of query heads, concatenated: views and one copy. A DTensor's kv
    heads are gathered whole over `model` first, one all-gather as XLA
    issues for the reference's `take` (slicing them sharded gathers once
    a slice); each rank then takes the kv heads of its own query heads
    (the result lies with its heads over `model`), so the gathered
    heads' gradient is a partial sum over `model`, all-reduced once
    (`meshctx.reduce_grad`), where a take of the whole heads would
    gather its gradient back."""
    G = H // Hkv
    runs = [min(h // G, Hkv - 1) for h in range(Hp)]

    def take(t_, heads):
        B, S, _, D = t_.shape
        return torch.cat([t_[:, :, j:j + 1].expand(B, S, heads.count(j), D)
                          for j in range(Hkv) if heads.count(j)], dim=2)
    t = reduce_grad(shard_hint(t, BATCH, None, None, None, site="attn.take"))
    model = t.device_mesh.mesh_dim_names.index("model")
    per = Hp // t.device_mesh.size(model)
    first = t.device_mesh.get_local_rank(model) * per
    B, S, _, D = t.shape
    return local_map(lambda t_: take(t_, runs[first:first + per]), (t,),
                     ((BATCH, None, None, None),),
                     ((BATCH, None, "model", None),), ((B, S, Hp, D),),
                     site="attn.take_heads")


def attention_block(p, x, *, cfg, positions, kv_x=None, kv_positions=None,
                    causal=True, rope=True, q_chunk=1024, kv_chunk=1024):
    """Full-sequence attention (prefill): causal self-attention, or, with
    `kv_x` (e.g. vision tokens), `causal=False` and `rope=False`,
    cross-attention. Returns (y, (k, v)).

    KV heads are expanded to the query heads before the flash core (the
    GQA expansion of the JAX package), and with a `model` axis of tp > 1
    the q-heads are zero-padded to Hp = ceil(H / tp) * tp and k and v
    expanded to Hp through kv_map = min(h // G, Hkv - 1), so the flash
    core shards over `model` whatever the GQA ratio; the padded heads'
    outputs are dropped. The returned cache k/v stay in their compact
    [B,Skv,Hkv,hd] form. `q_chunk`/`kv_chunk` are the plain version's
    chunks (the CPU path); the kernel tiles by itself."""
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(p, x, kv_x, cfg, positions, kv_positions,
                           rope=rope)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    tp = axis_size("model")
    Hp = -(-H // tp) * tp
    if tp > 1:
        B, Sq = q.shape[0], q.shape[1]
        qp = q
        if Hp != H:
            qp = torch.cat([q, torch.zeros((B, Sq, Hp - H, hd),
                                           dtype=q.dtype, device=q.device)],
                           dim=2)
        k_exp, v_exp = _take_heads(k, H, Hkv, Hp), _take_heads(v, H, Hkv, Hp)
    else:
        qp, k_exp, v_exp = q, _expand_kv(k, cfg), _expand_kv(v, cfg)
    spec = (BATCH, None, "model", None)
    qp = shard_hint(qp, *spec, site="attn.flash_in.q")
    k_exp = shard_hint(k_exp, *spec, site="attn.flash_in.k")
    v_exp = shard_hint(v_exp, *spec, site="attn.flash_in.v")
    o = local_map(
        lambda q_, k_, v_: flash_ops.flash_attention(
            q_, k_, v_, causal=causal, qc=q_chunk, kc=kv_chunk),
        (qp, k_exp, v_exp), (spec,) * 3, (spec,), (tuple(qp.shape),),
        site="attn.flash")
    if Hp != H:
        o = o[:, :, :H]
    y = _out_proj(p["wo"], o, _attn_axes(cfg)[0])
    return y, (k, v)


def _cache_axes(k):
    """(heads, head_dim) axes of a decode cache k [B,S,Hkv,hd] over
    `model`, read off its own placements (`launch.sharding.
    cache_pspec_tree` lays it out): None for each off-mesh or where the
    cache is whole over `model`."""
    mesh = getattr(k, "device_mesh", None)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None, None
    q = k.placements[mesh.mesh_dim_names.index("model")]
    dim = q.dim % k.ndim if q.is_shard() else None
    return ("model" if dim == 2 else None), ("model" if dim == 3 else None)


def _scores(q, k):
    """Unscaled fp32 scores [B,Hkv,G,1,Skv] of one query token q
    [B,1,H,hd] against k [B,Skv,Hkv,hd], the query heads grouped by kv
    head."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd).float()
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(COMPUTE_DTYPE).float())


def _attend(s, v, hd: int, valid):
    """Scaled, masked softmax of the scores and its PV over v
    [B,Skv,Hkv,D]: bf16 weights, fp32 products of the bf16 values ->
    [B,1,H,D] bf16."""
    s = s / math.sqrt(hd)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE)
    o = torch.einsum("bhgqk,bkhd->bhgqd", w.float(),
                     v.to(COMPUTE_DTYPE).float()).to(COMPUTE_DTYPE)
    B, Hkv, G, _, D = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, Hkv * G, D)


def _decode_core(p, q, k, v, *, cfg, valid=None):
    """One query token over k/v [B,Skv,Hkv,D] with GQA grouping: fp32
    scores and PV of the bf16 values, bf16 weights; `valid` [Skv] masks
    keys out. Returns the projected output [B,1,d].

    On DTensors the cache stays where it lies: q (one token, small) is
    laid out as the cache (batch over `data`, heads or head_dim over
    `model`, `_cache_axes`), the scores and the PV are local, and with a
    head_dim-sharded cache the scores are partial sums whose all-reduce
    precedes the softmax; the output goes back to q's heads layout for
    the output projection."""
    hd = cfg.resolved_head_dim
    B, Skv = k.shape[0], k.shape[1]
    Hkv, H = cfg.n_kv_heads, cfg.n_heads
    kh, kd = _cache_axes(k)
    kv = (FSDP, None, kh, kd)
    sc = (FSDP, kh, None, None, None)
    s = local_map(_scores, (q, k), (kv, kv), (sc,),
                  ((B, Hkv, H // Hkv, 1, Skv),), site="attn.decode.scores",
                  partial=("model",) if kd else ())
    s = shard_hint(s, *sc, site="attn.decode.softmax")
    o = local_map(lambda s_, v_: _attend(s_, v_, hd, valid), (s, v),
                  (sc, kv), ((FSDP, None, kh, kd),), ((B, 1, H, hd),),
                  site="attn.decode.pv")
    qh, qd = _attn_axes(cfg)[0]
    o = shard_hint(o, BATCH, None, qh, qd, site="attn.decode.out")
    return _out_proj(p["wo"], o, (qh, qd))


def decode_attention(p, x, cache_k, cache_v, cache_len: int, *, cfg):
    """One-token decode. x:[B,1,d]; cache_k/v:[B,Smax,Hkv,D]; cache_len an
    int. Writes the new k/v into the cache in place (the JAX package
    donates the cache and returns an updated copy; on a DTensor cache each
    rank writes its own shard, `meshctx.assign`). Returns
    (y, cache_k, cache_v)."""
    B, Smax = cache_k.shape[0], cache_k.shape[1]
    positions = torch.full((B, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, cfg, positions, positions)
    at = slice(cache_len, cache_len + 1)
    assign(cache_k[:, at], k_new.to(cache_k.dtype))
    assign(cache_v[:, at], v_new.to(cache_v.dtype))
    valid = torch.arange(Smax, device=x.device) <= cache_len
    y = _decode_core(p, q, cache_k, cache_v, cfg=cfg, valid=valid)
    return y, cache_k, cache_v


def decode_cross_attention(p, x, cross_k, cross_v, *, cfg):
    """One-token attention over a fixed (precomputed) KV set, no RoPE and
    no mask. x:[B,1,d]; cross_k/v:[B,Tv,Hkv,D]. Only q is projected: the
    JAX package also projects k and v of x and drops them."""
    return _decode_core(p, _project_q(p, x, cfg), cross_k, cross_v, cfg=cfg)
