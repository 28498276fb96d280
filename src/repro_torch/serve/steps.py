"""Serving steps: prefill (full sequence, builds the cache) and decode (one
token against the cache), as in the JAX package's `serve/steps.py`."""
from __future__ import annotations

import torch

from repro_torch.models import model as M


def make_prefill_step(cfg, *, q_chunk: int = 1024, kv_chunk: int = 1024,
                      ssd_chunk: int = 128):
    def prefill_step(params, batch):
        logits, cache = M.prefill(params, cfg, batch, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk, ssd_chunk=ssd_chunk)
        # only the final position's logits: the next-token distribution
        return logits[:, -1:], cache
    return prefill_step


def make_decode_step(cfg):
    """One greedy decode step; `embeds` [B,1,d] instead of the token for
    the audio family. Over a mesh the params are DTensors and the cache is
    laid out by `launch.sharding.cache_sharding_tree` (what the prefill
    step returns)."""
    def decode_step(params, cache, token, cache_len: int, embeds=None):
        logits, cache = M.decode_step(params, cfg, token, cache, cache_len,
                                      embeds=embeds)
        return greedy(logits[:, -1])[:, None], cache
    return decode_step


def greedy(logits):
    """argmax over the vocab of logits [B, V]. On a DTensor whose vocab
    lies over `model`, each rank takes the max of its own slice and the
    first of the ranks' maxima wins, the lowest index of a tie as
    `torch.argmax` takes it; only the ranks' [2, B] (value, index) pairs
    move. (DTensor's own argmax over a sharded dim fails where the batch
    is whole over `data`, as a decode of batch 1 has it.)"""
    from repro_torch.meshctx import BATCH, is_dtensor, local_map
    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    m = names.index("model") if "model" in names else None
    q = None if m is None else logits.placements[m]
    if q is None or not (q.is_shard() and q.dim == logits.ndim - 1):
        return torch.argmax(logits, dim=-1)
    tp = mesh.size(m)
    off = mesh.get_local_rank(m) * (logits.shape[-1] // tp)

    def local(x):
        v, i = x.max(dim=-1)
        return torch.stack([v, (i + off).to(v.dtype)])[None]
    pairs = local_map(local, (logits,), ((BATCH, "model"),),
                      (("model", None, BATCH),),
                      ((tp, 2, logits.shape[0]),))

    def pick(pr):
        best = torch.argmax(pr[:, 0], dim=0)
        return torch.gather(pr[:, 1], 0, best[None])[0].long()
    return local_map(pick, (pairs,), ((None, None, BATCH),), ((BATCH,),),
                     ((logits.shape[0],),))


def grow_cache(cache, max_seq: int):
    """A prefill's cache with the sequence axis of its attention k/v
    ([..., B, S, Hkv, hd]) zero-padded to `max_seq`; the ssm state, conv
    tails and cross-attention k/v as they are. On a DTensor each rank pads
    its own shard (the sequence axis is never split)."""
    from torch._prims_common import make_contiguous_strides_for

    from repro_torch.meshctx import is_dtensor

    def pad(t):
        n = max_seq - t.shape[-3]
        if not is_dtensor(t):
            return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
        from torch.distributed.tensor import DTensor
        loc = torch.nn.functional.pad(t.to_local(), (0, 0, 0, 0, 0, n))
        shape = (*t.shape[:-3], max_seq, *t.shape[-2:])
        return DTensor.from_local(loc, t.device_mesh, t.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=make_contiguous_strides_for(shape))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: pad(v) if k in ("k", "v") else walk(v)
                    for k, v in tree.items()}
        return tree
    return walk(cache)

