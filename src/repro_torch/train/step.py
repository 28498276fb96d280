"""The train step: remat'd forward and backward, optional int8
error-feedback gradient compression, AdamW. The port of the JAX package's
`train/step.py` on one device.

The step updates the state in place (params, moments, residuals, step)
and returns it with the step's metrics as 0-d tensors. Gradients are
taken with `torch.autograd.grad` of detached aliases of the params, so the
state's tensors never carry `requires_grad`.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.grad_compress import compress_with_feedback
from repro_torch.optim.tree import tree_leaves, tree_unflatten


def _grads_and_metrics(cfg, params, batch, kw):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                  **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (the audio family's token table) has
    # a zero gradient, as under jax.grad
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg, hp: AdamWConfig, *, grad_compression: bool = False,
                    remat: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024, ssd_chunk: int = 128,
                    microbatches: int = 1):
    """`train_step(state, batch) -> (state, metrics)`. microbatches > 1 is
    gradient accumulation: the batch is split into k sequential
    microbatches whose fp32 gradients are summed and divided by k, and
    the metrics are the microbatches' means (the JAX package's
    `lax.scan`)."""
    kw = dict(remat=remat, q_chunk=q_chunk, kv_chunk=kv_chunk,
              ssd_chunk=ssd_chunk)

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            grads, metrics = _grads_and_metrics(cfg, params, batch, kw)
        else:
            k = microbatches
            split = {n: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
                     for n, v in batch.items() if v is not None}
            acc, ms = None, []
            for i in range(k):
                g, m = _grads_and_metrics(
                    cfg, params, {n: v[i] for n, v in split.items()}, kw)
                g = [t.float() for t in tree_leaves(g)]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                ms.append(m)
            grads = tree_unflatten(params, [a / k for a in acc])
            metrics = {n: torch.stack([m[n] for m in ms]).mean()
                       for n in ms[0]}
        if grad_compression:
            grads, state["residuals"] = compress_with_feedback(
                grads, state["residuals"])
        _, _, om = adamw_update(params, grads, state["opt"], state["step"],
                                hp)
        with torch.no_grad():
            state["step"] += 1
        return state, {**metrics, **om}

    return train_step


def make_eval_step(cfg, *, q_chunk: int = 1024, kv_chunk: int = 1024,
                   ssd_chunk: int = 128):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = M.loss_fn(params, cfg, batch, remat=False,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               ssd_chunk=ssd_chunk)
        return metrics
    return eval_step
