"""Mixture-of-Experts FFN: top-k routing with group-local sort-based
capacity dispatch, the port of the JAX package's `models/moe.py`.

Dispatch is per group (one group = one sequence): the (token, choice)
assignments are sorted by expert id within their group, the first
`capacity` of each expert fill a [B, E, C, d] buffer, and the rest are
dropped (stable sort: a hot expert drops the latest positions). The expert
products are batched matrix products over E.

On DTensors the reference's hints hold: the buffer goes from batch-sharded
to expert-sharded (the dispatch all-to-all), the experts' hidden layer is
column-parallel over `data`, and the output is combined back onto the
batch. The routing, the dispatch's index work (sorts, searches, gathers,
the scatter into the buffer) and the combine are local along the batch
and run under `local_map` on each rank's batch shard.

Supports shared experts (deepseek-moe), a dense residual path (arctic) and
the Switch-style load-balancing aux loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.meshctx import BATCH, is_dtensor, local_map, shard_hint
from repro_torch.models.layers import (COMPUTE_DTYPE, _dense_init,
                                       init_swiglu, swiglu)

FSDP_AX = "data"


def init_moe(gen, cfg, *, device, dtype=torch.float32):
    """The router is fp32 whatever `dtype` is, as in the JAX package."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    p = {
        "router": _dense_init(gen, (d, E), device=device, fan_in=d,
                              dtype=torch.float32),
        "experts": {
            "gate": _dense_init(gen, (E, d, f), fan_in=d, **kw),
            "up": _dense_init(gen, (E, d, f), fan_in=d, **kw),
            "down": _dense_init(gen, (E, f, d), fan_in=f, **kw),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = init_swiglu(gen, d, cfg.n_shared_experts * f, **kw)
    if cfg.dense_residual:
        p["dense"] = init_swiglu(gen, d, cfg.dense_d_ff, **kw)
    return p


def _capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)                          # round up to 8


def route(p, x, cfg):
    """x: [B,S,d] -> (probs [B,S,E] fp32, top_w [B,S,k] renormalised,
    top_e [B,S,k]). The router product is full fp32 (TF32 stays off, as
    its default is: it would change the choices). Top-k is the first k of
    a stable descending sort, so a tie puts the lower expert first, as
    `jax.lax.top_k` does (`torch.topk` promises no order on ties)."""
    logits = torch.matmul(x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :cfg.top_k], top_e[..., :cfg.top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def dispatch(top_e, n_experts: int, capacity: int):
    """Group-local slots of the assignments. top_e: [B,S,k] -> (order,
    slot, valid), each [B,S*k] over the assignments sorted by expert
    (stable): `order` the assignment index, `slot` its row of the [E*C]
    buffer or E*C (the overflow row) when dropped, `valid` not dropped."""
    B = top_e.shape[0]
    E, C = n_experts, capacity
    e_flat = top_e.reshape(B, -1)                           # [B,S*k]
    order = torch.argsort(e_flat, dim=-1, stable=True)
    sorted_e = torch.gather(e_flat, 1, order)
    experts = torch.arange(E, device=top_e.device).expand(B, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")   # [B,E]
    seg_pos = (torch.arange(e_flat.shape[1], device=top_e.device)[None]
               - torch.gather(starts, 1, sorted_e))
    valid = seg_pos < C
    slot = torch.where(valid, sorted_e * C + seg_pos, E * C)
    return order, slot, valid


def _dispatch_local(x, router, cfg, C):
    """Routing and the group-local dispatch of x [B,S,d] (a rank's batch
    rows): (buf [B,E,C,d] bf16, order, slot [B,S*k], top_w [B,S,k],
    probs [B,S,E], top_e [B,S,k])."""
    Bb, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs, top_w, top_e = route({"router": router}, x, cfg)
    order, slot, valid = dispatch(top_e, E, C)
    tok_of_assign = order // k                              # [B,S*k]
    gathered = torch.gather(x.to(COMPUTE_DTYPE), 1,
                            tok_of_assign[..., None].expand(-1, -1, d))
    gathered = torch.where(valid[..., None], gathered, 0)
    buf = torch.zeros((Bb, E * C + 1, d), dtype=COMPUTE_DTYPE,
                      device=x.device)
    # every dropped assignment writes its zeros to the one overflow row E*C,
    # the only index written twice: the order of those writes cannot matter
    rows = torch.arange(Bb, device=x.device)[:, None]
    buf[rows, slot] = gathered
    buf = buf[:, :-1].reshape(Bb, E, C, d)
    return buf, order, slot, top_w, probs, top_e


def _combine_local(out, slot, order, top_w, k: int):
    """The experts' output rows [B,E,C,d] back to the tokens: each
    assignment's row (zeros where it was dropped), the fp32 weighted sum
    over the k choices, then bf16 -> [B,S,d]."""
    Bb, E, C, d = out.shape
    out_flat = torch.cat([out.reshape(Bb, E * C, d),
                          torch.zeros((Bb, 1, d), dtype=COMPUTE_DTYPE,
                                      device=out.device)], dim=1)
    y_sorted = torch.gather(out_flat, 1, slot[..., None].expand(-1, -1, d))
    inv = torch.argsort(order, dim=-1)
    y_assign = torch.gather(y_sorted, 1, inv[..., None].expand(-1, -1, d))
    y_assign = y_assign.reshape(Bb, -1, k, d)
    y = torch.einsum("bskd,bsk->bsd", y_assign.float(), top_w.float())
    return y.to(COMPUTE_DTYPE)


def moe_ffn(p, x, cfg, *, return_aux=True):
    """x: [B,S,d] -> (y bf16 [B,S,d], aux fp32 scalar). Groups = batch
    rows."""
    Bb, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(S, cfg)

    # ---- routing and the group-local dispatch, local along the batch ---------
    row = (BATCH, None)
    buf, order, slot, top_w, probs, top_e = local_map(
        lambda x_, r_: _dispatch_local(x_, r_, cfg, C), (x, p["router"]),
        ((BATCH, None, None), (None, None)),
        ((BATCH, None, None, None), row, row, (BATCH, None, None),
         (BATCH, None, None), (BATCH, None, None)),
        ((Bb, E, C, d), (Bb, S * k), (Bb, S * k), (Bb, S, k), (Bb, S, E),
         (Bb, S, k)), site="moe.dispatch")
    # batch-sharded -> expert-sharded: the MoE all-to-all
    buf = shard_hint(buf, BATCH, "model", None, None, site="moe.buf")
    buf = buf.transpose(0, 1).reshape(E, Bb * C, d)         # [E,B*C,d]
    buf = shard_hint(buf, "model", None, None, site="moe.buf_experts")

    # ---- expert products: fp32 products of the bf16 values (JAX: bf16
    # einsums with preferred_element_type=float32); down is bf16 in and
    # out, like `linear` -----------------------------------------------
    ex = p["experts"]
    bf = buf.float()
    g = torch.bmm(bf, ex["gate"].to(COMPUTE_DTYPE).float())
    u = torch.bmm(bf, ex["up"].to(COMPUTE_DTYPE).float())
    h = (F.silu(g) * u).to(COMPUTE_DTYPE)
    h = shard_hint(h, "model", None, FSDP_AX, site="moe.hidden")
    out = torch.bmm(h, ex["down"].to(COMPUTE_DTYPE))        # [E,B*C,d]
    out = out.reshape(E, Bb, C, d).transpose(0, 1)          # [B,E,C,d]
    out = shard_hint(out, BATCH, None, None, None, site="moe.combine")

    # ---- combine: fp32 weighted sum over the k choices, then bf16 -----------
    y = local_map(lambda o_, s_, r_, w_: _combine_local(o_, s_, r_, w_, k),
                  (out, slot, order, top_w),
                  ((BATCH, None, None, None), row, row, (BATCH, None, None)),
                  ((BATCH, None, None),), ((Bb, S, d),), site="moe.y")
    y = shard_hint(y, BATCH, None, None, site="moe.out")
    if "shared" in p:
        y = y + swiglu(p["shared"], x)
    if "dense" in p:
        y = y + swiglu(p["dense"], x)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_aux:
        # Switch-style load-balance loss: E * sum_e f_e * P_e
        f_e = _expert_counts(top_e, E) / (Bb * S * k)
        P_e = probs.mean(dim=(0, 1))
        aux = E * torch.sum(f_e * P_e)
    return y, aux


def _expert_counts(top_e, E: int):
    """The assignments of each expert, fp32 [E]: a `bincount` of a plain
    tensor; of a DTensor a compare-and-sum, whose sum over the sharded
    batch DTensor reduces."""
    if not is_dtensor(top_e):
        return torch.bincount(top_e.reshape(-1), minlength=E).float()
    experts = torch.arange(E, device=top_e.device)
    return (top_e[..., None] == experts).float().sum(dim=(0, 1, 2))
