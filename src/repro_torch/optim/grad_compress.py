"""Int8 error-feedback gradient compression: the port of the JAX package's
`optim/grad_compress.py`. Each leaf (plus its carried residual) is
quantized to int8 with a per-tensor scale and dequantized; the residual
keeps the quantization error for the next step. `torch.round` rounds half
to even, as `jnp.round` does.
"""
from __future__ import annotations

import torch

from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten


def quantize(x):
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def compress_with_feedback(grads, residuals):
    """Returns (the grads after int8, as fp32; the new residuals)."""
    out = []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        g = g.float() + r
        q, scale = quantize(g)
        deq = dequantize(q, scale)
        out.append((deq, g - deq))
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
