"""The train step: remat'd forward and backward, optional int8
error-feedback gradient compression, AdamW. The port of the JAX package's
`train/step.py`.

The step updates the state in place (params, moments, residuals, step)
and returns it with the step's metrics as 0-d tensors. It runs inside a
`train.step` span holding `train.fwd_bwd` (the gradients) and
`train.adamw` (the update), `core/dxt.py`'s profiler ranges. Gradients are
taken with `torch.autograd.grad` of detached aliases of the params, so the
state's tensors never carry `requires_grad`.

A state of DTensors (`train.state.train_state_shardings` on a
`DeviceMesh` whose axes are among "pod", "data" and "model", one device
or many) steps as DTensors under `meshctx.dtensor_scope`: the forward
runs over the mesh with the reference's hints, and the optimizer updates
each leaf in place through its local tensor, so the `Trainer` and
`CheckpointManager` see the new values. A plain batch is sharded over
the batch axes first (`train.state.shard_batch`). The embedding and head
tables are gathered over the batch axes once a step (`_gather_tables`),
as XLA hoists the reference's gathers of them out of its microbatch
loop; the layers' weights are gathered at each use (ZeRO-3), and their
gradients are reduced over the batch axes into their own shards when
each layer's backward ends (`meshctx.reduce_grads_once`), so a rank
holds one layer's whole gradient at a time. The tables' gradients stay
partial sums over the batch axes, are added over the microbatches as
they are, and are reduced once a step; each gradient is then laid out
as its optimizer moment (`meshctx.reduce_partials`).
"""
from __future__ import annotations

import torch

from repro_torch.core.dxt import TRACER
from repro_torch.launch.sharding import gathered_once_tree
from repro_torch.meshctx import (BATCH, dtensor_scope, full_values,
                                 is_dtensor, mesh_of, reduce_partials,
                                 shard_hint)
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.grad_compress import compress_with_feedback
from repro_torch.optim.tree import tree_leaves, tree_unflatten

AXES = ("pod", "data", "model")


def _grads_and_metrics(cfg, params, batch, kw):
    """Gradients of the loss at `params` (on a mesh, as the backward
    leaves them: the layers' reduced, the tables' partial sums over the
    batch axes) and the metrics."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad(), TRACER.span("fwd_bwd", layer="train"):
        loss, metrics = M.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                  **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (the audio family's token table) has
    # a zero gradient, as under jax.grad
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def _gather_tables(params):
    """`params` with the leaves that the partition rules gather once a
    step (`launch.sharding.gathered_once_tree`: the embedding and head
    tables) gathered over the batch axes, laid out as their readers take
    them (the vocab over `model`, the rest whole); the others as they
    are."""
    from torch.distributed.tensor import Replicate
    leaves = tree_leaves(params)
    once = tree_leaves(gathered_once_tree(params))
    return tree_unflatten(params, [
        t.redistribute(t.device_mesh, [
            Replicate() if n in BATCH else q for n, q in
            zip(t.device_mesh.mesh_dim_names, t.placements)])
        if g and is_dtensor(t) else t for t, g in zip(leaves, once)])


def _check_mesh(mesh):
    bad = [a for a in mesh.mesh_dim_names if a not in AXES]
    if bad:
        raise ValueError(f"a train step over a mesh with axes "
                         f"{tuple(mesh.mesh_dim_names)}: the axes must be "
                         f"among {AXES}, not {bad}")


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
        with TRACER.span("step", layer="train"), dtensor_scope(mesh):
            return _step(state, batch, mesh)

    def _step(state, batch, mesh):
        params = state["params"]
        run_on = params if mesh is None else _gather_tables(params)
        if microbatches == 1:
            grads, metrics = _grads_and_metrics(cfg, run_on, batch, kw)
            grads = tree_leaves(grads)
            ms = [metrics]
        else:
            k = microbatches
            split = {n: _rows(v, k) for n, v in batch.items()
                     if v is not None}
            acc, ms = None, []
            for i in range(k):
                mb = {n: shard_hint(v[i], BATCH, *([None] * (v.ndim - 2)),
                                    site="step.microbatch")
                      for n, v in split.items()}
                g, m = _grads_and_metrics(cfg, run_on, mb, kw)
                g = [_on_locals(lambda t: t.float(), t)
                     for t in tree_leaves(g)]
                acc = g if acc is None else [_on_locals(torch.add, a, b)
                                             for a, b in zip(acc, g)]
                ms.append(m)
            grads = [_on_locals(lambda t: t / k, a) for a in acc]
        if mesh is not None:
            # the gradients still partial (the tables') reduced once, each
            # laid out as its moment
            grads = reduce_partials(grads, [m.placements for m in
                                            tree_leaves(state["opt"]["m"])])
        grads = tree_unflatten(params, grads)
        names = list(ms[0])
        full = full_values([m[n] for m in ms for n in names])
        if microbatches == 1:
            metrics = dict(zip(names, full))
        else:
            metrics = {n: torch.stack(full[j::len(names)]).mean()
                       for j, n in enumerate(names)}
        with torch.no_grad(), TRACER.span("adamw", layer="train"):
            if grad_compression:
                grads, residuals = compress_with_feedback(
                    grads, state["residuals"])
                for dst, src in zip(tree_leaves(state["residuals"]),
                                    tree_leaves(residuals)):
                    _local(dst).copy_(_local(src))
            _, _, om = adamw_update(params, grads, state["opt"],
                                    state["step"], hp)
            _local(state["step"]).add_(1)
        return state, {**metrics, **om}

    return train_step


def _on_locals(fn, *xs):
    """`fn` of the local tensors of DTensors laid out alike (a partial sum
    stays one: `fn` is linear), as a DTensor so laid out; of plain
    tensors, `fn` of them."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    from torch.distributed.tensor import DTensor
    a = xs[0]
    locs = [x.to_local() if tuple(x.placements) == tuple(a.placements)
            else x.redistribute(a.device_mesh, a.placements).to_local()
            for x in xs]
    return DTensor.from_local(fn(*locs), a.device_mesh, a.placements,
                              run_check=False, shape=a.shape,
                              stride=a.stride())


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
        return dict(zip(metrics, full_values(metrics.values())))
    return eval_step
