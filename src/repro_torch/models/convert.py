"""Carry parameters and caches between the JAX package and the port, as
numpy arrays: the JAX package's parameter pytree (stacked `layers [L, ...]`,
`units [U, I, ...]` and the like) becomes the port's nested dicts with
per-layer lists, and a decode cache of either package becomes numpy for
comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

#: keys whose leaves carry stacked layers: the number of leading axes that
#: are unstacked into (nested) lists (`first`: the moe family's dense first
#: layers; `self_units` and `cross`: the vlm family's [U, I-1] self layers
#: and [U] cross layers)
_STACKED = {"layers": 1, "units": 2, "first": 1, "self_units": 2, "cross": 1}


def _tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes, as JAX hands it out
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)     # a writable copy


def _take(tree, i):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _lead(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _unstack(tree, depth, dev):
    if depth == 0:
        return _convert(tree, dev)
    return [_unstack(_take(tree, i), depth - 1, dev)
            for i in range(_lead(tree))]


def _convert(tree, dev):
    if isinstance(tree, dict):
        return {k: (_unstack(v, _STACKED[k], dev) if k in _STACKED
                    else _convert(v, dev)) for k, v in tree.items()}
    return _tensor(tree, dev)


def params_from_numpy(cfg, tree, *, device=None):
    """The JAX package's params of `cfg` (a pytree of numpy arrays, e.g.
    `jax.tree_util.tree_map(np.asarray, params)`) as the port's params on
    `device` (CUDA unless `device="cpu"`)."""
    dev = resolve_device(device)
    if set(tree) - {"embed", "stack", "final_norm", "lm_head"}:
        raise ValueError(f"not a parameter tree of {cfg.name}: keys "
                         f"{sorted(tree)}")
    return _convert(tree, dev)


def cache_to_numpy(cache):
    """A decode cache (nested dict / tuple of tensors) as float32 numpy
    arrays in the same structure."""
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(cache_to_numpy(v) for v in cache)
    return cache.detach().float().cpu().numpy()
