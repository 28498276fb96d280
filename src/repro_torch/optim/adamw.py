"""AdamW with global-norm clipping and a warmup-cosine schedule: the port
of the JAX package's `optim/adamw.py`, line by line (fp32 moments, the
clip scale from the global norm, bias correction at step + 1, decoupled
weight decay on leaves of rank >= 2 only). Not `torch.optim.AdamW`, whose
order of operations differs.

The update is in place: params, m and v are overwritten under
`torch.no_grad()` (the JAX package returns new arrays). Step, lr and the
scales stay 0-d tensors on the params' device, so an update makes no host
round trip.

The decay test reads a leaf's rank in the JAX package's stacked layout
(`tree.jax_ndims`): there a layer's norm scale or bias is one row of an
[L, d] array, so it is decayed, while the final norm's [d] is not. The
port's per-layer [d] leaves are decayed alike, so both packages take the
same step.

On DTensor leaves the global norm is the global reduction it is in the
reference (each leaf's sum of squares reduced over the mesh), and each
leaf is updated through its local tensors in the layout of its moments
(the gradient brought into that layout first); a param laid out otherwise
(replicated over `pod` where its moments are sharded, ZeRO-1) gets its new
value back in its own layout.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.meshctx import full_values, is_dtensor
from repro_torch.optim.tree import jax_ndims, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(hp: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to `lr`, then cosine down to `min_lr_ratio * lr`;
    `step` a 0-d integer tensor, the result a 0-d fp32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(hp.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - hp.warmup_steps)
                    / max(hp.total_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = hp.min_lr_ratio + (1 - hp.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return hp.lr * warm * cos


def init_opt_state(params) -> dict:
    """fp32 zeros shaped like each param: {"m": tree, "v": tree}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in the JAX package's order) of each
    leaf's fp32 sum of squares (of a DTensor leaf, over the whole mesh:
    the leaves' partial sums in one all-reduce a mesh dim,
    `meshctx.full_values`)."""
    return torch.sqrt(sum(full_values(
        [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)])))


def _in_layout(x, like):
    """DTensor `x` redistributed to the layout of `like`."""
    if tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


@torch.no_grad()
def adamw_update(params, grads, opt_state, step, hp: AdamWConfig):
    """One AdamW step on `params` and `opt_state` in place. Returns
    (params, opt_state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(hp.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    step = step.to_local() if is_dtensor(step) else step
    lr = schedule(hp, step)
    b1, b2 = hp.b1, hp.b2
    t = step.float() + 1.0
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, nd, g, m, v in zip(tree_leaves(params), jax_ndims(params),
                              tree_leaves(grads),
                              tree_leaves(opt_state["m"]),
                              tree_leaves(opt_state["v"])):
        if is_dtensor(m):
            _update_sharded(p, nd, g, m, v, scale, lr, bc1, bc2, hp)
        else:
            _update(p, nd, g, m, v, scale, lr, bc1, bc2, hp)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def _update(p, nd, g, m, v, scale, lr, bc1, bc2, hp):
    """One leaf's update in place, on plain tensors."""
    b1, b2 = hp.b1, hp.b2
    g = g.float() * scale
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * torch.square(g))
    delta = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
    if nd >= 2:  # decoupled weight decay on matrices only
        delta = delta + hp.weight_decay * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))


def _update_sharded(p, nd, g, m, v, scale, lr, bc1, bc2, hp):
    """One DTensor leaf's update in place, on the local tensors in the
    moments' layout: the same operations as `_update`, element for
    element."""
    pm = _in_layout(p, m)
    _update(pm.to_local(), nd, _in_layout(g, m).to_local(), m.to_local(),
            v.to_local(), scale, lr, bc1, bc2, hp)
    if pm is not p:             # a copy in the moments' layout: bring back
        p.to_local().copy_(_in_layout(pm, p).to_local())
