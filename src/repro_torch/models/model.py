"""Top-level LM: embeddings -> family stack -> final norm -> logits. The
port of the JAX package's `models/model.py`:
    init_params(cfg, seed, device=...)              -> params (nested dicts)
    forward(params, cfg, batch, ...)                -> (logits, aux)
    prefill(params, cfg, batch, ...)                -> (logits, cache)
    decode_step(params, cfg, token, cache, length)  -> (logits, cache)
    loss_fn(params, cfg, batch, ...)                -> (loss, metrics)
    make_decode_cache_spec / init_decode_cache
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device
from repro_torch.models.layers import (COMPUTE_DTYPE, embed, init_embedding,
                                       init_rmsnorm, rms_norm, unembed)
from repro_torch.models.transformer import stack_for

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg):
    return _DTYPES[cfg.param_dtype]


# ------------------------------------------------------------------- init
def _init(cfg, gen, device):
    dtype = _dtype(cfg)
    stack = stack_for(cfg)
    p = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                device=device, dtype=dtype),
        "stack": stack.init(gen, cfg, device=device, dtype=dtype),
        "final_norm": init_rmsnorm(cfg.d_model, device=device, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                      device=device, dtype=dtype)
    return p


def init_params(cfg, seed: int = 0, *, device=None):
    """Random params with the JAX package's distributions (normal draws
    scaled by 1/sqrt(fan_in), embeddings by 0.02, norms at 1, the Mamba2
    constants), drawn from a `torch.Generator` on `device` (CUDA unless
    `device="cpu"`). The draws differ from JAX's: tests carry JAX's params
    across with `convert.params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init(cfg, gen, dev)


def leaves(tree):
    """The tensors of a nested dict / list / tuple, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def param_shapes(cfg):
    """The params of `init_params` on the meta device: shapes and dtypes,
    no storage (so a 480B config costs nothing)."""
    return _init(cfg, None, torch.device("meta"))


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Parameter count by shape arithmetic; with `active_only`, the routed
    experts count top_k / n_experts of their size (the JAX package's
    rounding: the experts' total times top_k, floor-divided by
    n_experts)."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(t.shape) for t in leaves(shapes))
    if active_only and cfg.n_experts:
        esz = sum(math.prod(t.shape) for layer in shapes["stack"]["layers"]
                  for t in leaves(layer["moe"]["experts"]))
        total = total - esz + esz * cfg.top_k // cfg.n_experts
    return total


# ---------------------------------------------------------------- forward
def _embed_inputs(params, cfg, batch):
    if batch.get("embeds") is not None:          # the audio family
        x = batch["embeds"].to(COMPUTE_DTYPE)
    else:
        x = embed(params["embed"], batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    return x, positions


def _head(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def forward(params, cfg, batch, *, remat=False, with_cache=False,
            q_chunk=1024, kv_chunk=1024, ssd_chunk=128):
    """batch: {tokens | embeds [B,S,d] (audio), positions?, vision_embeds?
    [B,Tv,d] (vlm)}. Causal full-sequence pass; logits are fp32 [B,S,V].
    `remat` checkpoints the stack's layer bodies (training)."""
    x, positions = _embed_inputs(params, cfg, batch)
    kw = {}
    if cfg.family == "vlm":
        kw["vision_embeds"] = batch["vision_embeds"].to(COMPUTE_DTYPE)
    x, aux, cache = stack_for(cfg).seq(
        params["stack"], x, cfg, positions=positions, remat=remat,
        with_cache=with_cache, q_chunk=q_chunk, kv_chunk=kv_chunk, ssd_chunk=ssd_chunk, **kw)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(_head(params, cfg), x)
    return (logits, aux, cache) if with_cache else (logits, aux)


def prefill(params, cfg, batch, **kw):
    logits, _, cache = forward(params, cfg, batch, with_cache=True, **kw)
    return logits, cache


def decode_step(params, cfg, token, cache, cache_len: int):
    """One-token decode. token:[B,1] int; cache_len an int. Updates `cache`
    in place and returns (logits [B,1,V], cache)."""
    x = embed(params["embed"], token)
    x, cache = stack_for(cfg).step(params["stack"], x, cache, cache_len, cfg)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(_head(params, cfg), x), cache


# ------------------------------------------------------------------- loss
def loss_fn(params, cfg, batch, *, remat=True, aux_weight=0.01,
            q_chunk=1024, kv_chunk=1024, ssd_chunk=128):
    """Next-token cross-entropy; batch needs `labels` [B,S] (-100 =
    ignore). fp32 log-sum-exp, the gold logit as a one-hot compare-select-
    sum (as the JAX package computes it), mean over the valid tokens, plus
    `aux_weight` times the stack's aux loss (the moe family's router
    load-balance loss). Returns (loss, metrics) with the loss a 0-d
    tensor."""
    logits, aux = forward(params, cfg, batch, remat=remat, q_chunk=q_chunk,
                          kv_chunk=kv_chunk, ssd_chunk=ssd_chunk)
    labels = batch["labels"]
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    vocab_iota = torch.arange(logits.shape[-1], dtype=safe.dtype,
                              device=logits.device)
    onehot = (safe[..., None] == vocab_iota).to(logits.dtype)
    gold = torch.sum(logits * onehot, dim=-1)
    nll = (logz - gold) * valid
    denom = torch.clamp_min(valid.sum(), 1)
    ce = nll.sum() / denom
    total = ce + aux_weight * aux
    return total, {"loss": total, "ce": ce, "aux": aux,
                   "tokens": denom.float()}


def make_decode_cache_spec(cfg, B, S):
    return stack_for(cfg).cache_spec(cfg, B, S)


def _map_spec(fn, spec):
    if isinstance(spec, dict):
        return {k: _map_spec(fn, v) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return tuple(_map_spec(fn, v) for v in spec)
    return fn(spec)


def init_decode_cache(cfg, B, S, *, device=None):
    """A zeroed decode cache of capacity S, on `device` (CUDA unless
    `device="cpu"`)."""
    dev = resolve_device(device)
    return _map_spec(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                     make_decode_cache_spec(cfg, B, S))
