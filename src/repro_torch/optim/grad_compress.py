"""Int8 error-feedback gradient compression: the port of the JAX package's
`optim/grad_compress.py`. Each leaf (plus its carried residual) is
quantized to int8 with a per-tensor scale and dequantized; the residual
keeps the quantization error for the next step. `torch.round` rounds half
to even, as `jnp.round` does.

On DTensor leaves the scale comes from the absolute maximum over the whole
mesh, as the reference's is over the global array, and the rest is
elementwise on the local tensors in the residuals' layout.
"""
from __future__ import annotations

import torch

from repro_torch.meshctx import is_dtensor
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten


def quantize(x):
    """(int8 values, fp32 scale); of a DTensor, the int8 values as a
    DTensor of its layout and the scale of the whole array."""
    absmax = torch.max(torch.abs(x))
    if is_dtensor(x):
        absmax = absmax.full_tensor()
    scale = (absmax + 1e-12) / 127.0
    if not is_dtensor(x):
        return torch.clamp(torch.round(x / scale), -127, 127).to(
            torch.int8), scale
    q = torch.clamp(torch.round(x.to_local() / scale), -127, 127).to(
        torch.int8)
    return _like(q, x), scale


def _like(local, x):
    """A local tensor as a DTensor laid out as DTensor `x`."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def dequantize(q, scale):
    if is_dtensor(q):
        return _like(q.to_local().float() * scale, q)
    return q.float() * scale


def compress_with_feedback(grads, residuals):
    """Returns (the grads after int8, as fp32; the new residuals)."""
    out = []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        if is_dtensor(r):
            if tuple(g.placements) != tuple(r.placements):
                g = g.redistribute(r.device_mesh, r.placements)
            g = _like(g.to_local().float() + r.to_local(), r)
            q, scale = quantize(g)
            deq = dequantize(q, scale)
            out.append((deq, _like(g.to_local() - deq.to_local(), r)))
            continue
        g = g.float() + r
        q, scale = quantize(g)
        deq = dequantize(q, scale)
        out.append((deq, g - deq))
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
