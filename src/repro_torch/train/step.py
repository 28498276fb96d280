"""The train step: remat'd forward and backward, optional int8
error-feedback gradient compression, AdamW. The port of the JAX package's
`train/step.py`.

The step updates the state in place (params, moments, residuals, step)
and returns it with the step's metrics as 0-d tensors. Gradients are
taken with `torch.autograd.grad` of detached aliases of the params, so the
state's tensors never carry `requires_grad`.

A state of DTensors (`train.state.train_state_shardings` on a
`DeviceMesh` whose axes are among "pod", "data" and "model", one device
or many) steps as DTensors under `meshctx.dtensor_scope`: the forward
runs over the mesh with the reference's hints, each gradient is reduced
into the layout of its optimizer moments (the partial sums of the batch
shards, as the reference's SPMD partitioner reduces them), and the
optimizer updates each leaf in place through its local tensor, so the
`Trainer` and `CheckpointManager` see the new values. A plain batch is
sharded over the batch axes first (`train.state.shard_batch`).
"""
from __future__ import annotations

import torch

from repro_torch.meshctx import BATCH, dtensor_scope, is_dtensor, mesh_of
from repro_torch.meshctx import shard_hint
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.grad_compress import compress_with_feedback
from repro_torch.optim.tree import tree_leaves, tree_unflatten

AXES = ("pod", "data", "model")


def _grads_and_metrics(cfg, params, batch, kw, like):
    """Gradients of the loss at `params` (in the layouts of the leaves of
    `like`, on a mesh) and the metrics."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                  **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (the audio family's token table) has
    # a zero gradient, as under jax.grad
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    if like is not None:
        grads = [g.redistribute(t.device_mesh, t.placements)
                 for g, t in zip(grads, tree_leaves(like))]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def _check_mesh(mesh):
    bad = [a for a in mesh.mesh_dim_names if a not in AXES]
    if bad:
        raise ValueError(f"a train step over a mesh with axes "
                         f"{tuple(mesh.mesh_dim_names)}: the axes must be "
                         f"among {AXES}, not {bad}")


def _plain(x):
    """A metric as a plain tensor (a DTensor's full value)."""
    return x.full_tensor() if is_dtensor(x) else x


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
        mesh = mesh_of(state)
        if mesh is not None:
            _check_mesh(mesh)
            from repro_torch.train.state import shard_batch
            batch = shard_batch(batch, mesh)
        with dtensor_scope(mesh):
            return _step(state, batch, mesh)

    def _step(state, batch, mesh):
        params = state["params"]
        # gradients are reduced into the moments' layout
        like = state["opt"]["m"] if mesh is not None else None
        if microbatches == 1:
            grads, metrics = _grads_and_metrics(cfg, params, batch, kw, like)
        else:
            k = microbatches
            split = {n: _rows(v, k) for n, v in batch.items()
                     if v is not None}
            acc, ms = None, []
            for i in range(k):
                mb = {n: shard_hint(v[i], BATCH, *([None] * (v.ndim - 2)),
                                    site="step.microbatch")
                      for n, v in split.items()}
                g, m = _grads_and_metrics(cfg, params, mb, kw, like)
                g = [t.float() for t in tree_leaves(g)]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                ms.append(m)
            grads = tree_unflatten(params, [a / k for a in acc])
            metrics = {n: torch.stack([_plain(m[n]) for m in ms]).mean()
                       for n in ms[0]}
        with torch.no_grad():
            if grad_compression:
                grads, residuals = compress_with_feedback(
                    grads, state["residuals"])
                for dst, src in zip(tree_leaves(state["residuals"]),
                                    tree_leaves(residuals)):
                    _local(dst).copy_(_local(src))
            _, _, om = adamw_update(params, grads, state["opt"],
                                    state["step"], hp)
            _local(state["step"]).add_(1)
        return state, {**{k: _plain(v) for k, v in metrics.items()}, **om}

    return train_step


def _local(x):
    """The tensor to update in place: a DTensor's local one (the same
    storage), or `x`."""
    return x.to_local() if is_dtensor(x) else x


def _rows(v, k: int):
    """Batch rows [B, ...] as k microbatches [k, B // k, ...], the JAX
    package's reshape; a DTensor is gathered whole first (the batch is
    small) and each microbatch sharded again over the batch axes."""
    if is_dtensor(v):
        from torch.distributed.tensor import Replicate
        v = v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim)
    return v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))


def make_eval_step(cfg, *, q_chunk: int = 1024, kv_chunk: int = 1024,
                   ssd_chunk: int = 128):
    @torch.no_grad()
    def eval_step(params, batch):
        mesh = mesh_of(params)
        if mesh is not None:
            from repro_torch.train.state import shard_batch
            batch = shard_batch(batch, mesh)
        _, metrics = M.loss_fn(params, cfg, batch, remat=False,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               ssd_chunk=ssd_chunk)
        return {k: _plain(v) for k, v in metrics.items()}
    return eval_step
