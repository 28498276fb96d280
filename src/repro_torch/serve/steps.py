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
    def decode_step(params, cache, token, cache_len: int):
        logits, cache = M.decode_step(params, cfg, token, cache, cache_len)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache
    return decode_step
