"""Batched serving engine: prefill, then greedy decode over a cache of
fixed capacity `max_seq`, as the JAX package's `serve/engine.py`.

The engine holds one bf16 copy of the weights that the JAX package casts to
bf16 on every use (projection weights and biases, embedding tables, conv
taps, the experts' stacked gate/up/down): one cast gives the same values at
half the weight traffic. Norm scales, the Mamba2 constants, the MoE router
and the vlm gates stay in their dtype, since JAX reads them in fp32.
Generation runs under `torch.inference_mode()`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.serve.steps import make_decode_step, make_prefill_step

#: leaf names the JAX package reads through `.astype(COMPUTE_DTYPE)`; a
#: swiglu's "gate"/"up"/"down" are dicts (their "w" is cast), so a tensor
#: of those names is an MoE layer's stacked experts
_COMPUTE_LEAVES = ("w", "b", "table", "gate", "up", "down")


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 512
    max_new_tokens: int = 32


def cast_for_compute(tree, name=None):
    """A copy of the params with the leaves named in `_COMPUTE_LEAVES` in
    bf16; every other leaf is shared, not copied."""
    if isinstance(tree, dict):
        return {k: cast_for_compute(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_for_compute(v, name) for v in tree]
    return tree.to(COMPUTE_DTYPE) if name in _COMPUTE_LEAVES else tree


class ServeEngine:
    def __init__(self, cfg, params, scfg: ServeConfig):
        self.cfg = cfg
        self.scfg = scfg
        self.params = cast_for_compute(params)
        self.device = params["embed"]["table"].device
        self.prefill = make_prefill_step(
            cfg, q_chunk=min(256, scfg.max_seq),
            kv_chunk=min(256, scfg.max_seq))
        self.decode = make_decode_step(cfg)

    def generate(self, prompts, *, new_tokens: Optional[int] = None,
                 vision_embeds=None) -> np.ndarray:
        """prompts: [B, S_prompt] int (numpy or tensor, all of one length);
        vision_embeds: [B, n_vision_tokens, d_model] (numpy or tensor), a
        vlm config's image tokens. Greedy decode of `new_tokens`
        continuations for the whole batch; returns int32 [B, new_tokens]."""
        B, Sp = prompts.shape
        n_new = new_tokens or self.scfg.max_new_tokens
        if Sp + n_new > self.scfg.max_seq:
            raise ValueError(
                f"prompt length {Sp} + new tokens {n_new} exceeds the "
                f"serve cache budget max_seq={self.scfg.max_seq} — "
                f"shorten the prompt or raise ServeConfig.max_seq")
        if (vision_embeds is None) != (self.cfg.family != "vlm"):
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) takes "
                             f"vision_embeds if and only if it is a vlm")
        with torch.inference_mode():
            batch = {"tokens": torch.as_tensor(np.asarray(prompts),
                                               dtype=torch.int64,
                                               device=self.device)}
            if vision_embeds is not None:
                batch["vision_embeds"] = torch.as_tensor(vision_embeds,
                                                         device=self.device)
            logits, cache = self.prefill(self.params, batch)
            cache = self._grow_cache(cache)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out = [tok]
            for i in range(n_new - 1):
                tok, cache = self.decode(self.params, cache, tok, Sp + i)
                out.append(tok)
            return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()

    def _grow_cache(self, cache):
        """The prefill cache in a zeroed cache of capacity max_seq: the
        attention caches' sequence axis grows from the prompt's length to
        max_seq, the ssm state and conv tails copy as they are."""
        B = cache_batch(cache)
        full = M.init_decode_cache(self.cfg, B, self.scfg.max_seq,
                                   device=self.device)

        def grow(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    grow(dst[k], src[k])
            elif isinstance(dst, tuple):
                for d, s in zip(dst, src):
                    grow(d, s)
            else:
                dst[tuple(slice(0, n) for n in src.shape)] = src

        grow(full, cache)
        return full


def cache_batch(cache) -> int:
    """The batch of a decode cache: axis -4 of its first attention k
    ([..., B, S, Hkv, hd], at any depth: moe's under "moe") or Mamba2
    state ([..., B, H, P, N]). (The JAX package takes axis 1 of the first
    rank-5 leaf, which is right for every family but hybrid, whose conv
    tails [U, I, B, K-1, d] hold I there.)"""
    for name, leaf in cache.items():
        if name in ("k", "ssm"):
            return leaf.shape[-4]
        if isinstance(leaf, dict):
            return cache_batch(leaf)
    raise ValueError(f"not a decode cache: keys {sorted(cache)}")
