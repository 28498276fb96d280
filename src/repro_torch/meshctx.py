"""Ambient mesh for in-model sharding hints: the port of the JAX package's
`meshctx.py` on `torch.distributed`'s `DeviceMesh` and DTensor.

Model code calls `shard_hint(x, 'axis', ...)` to constrain intermediate
layouts (e.g. the MoE dispatch buffer). Outside a mesh context (unit tests,
single-device runs), and on a plain tensor, hints are no-ops, so the same
code runs everywhere. On a DTensor a hint redistributes it to the
placements of the spec (`launch.sharding.to_placements`).

Work that is local along the sharded dims (the kernels, the SSD scan's
chunked core, the MoE dispatch's index work) runs through `local_map`:
each rank calls the plain-tensor function on its local shards, laid out
as the reference's hint at that site, and the results come back as
DTensors. `dtensor_scope` is the context a forward or train step over
DTensors runs in: the mesh for the hints, and plain tensors made inside
the model (positions, masks, zeros) taken as replicated.

A spec entry names a mesh axis, a tuple of axes or None; axes absent from
the mesh are dropped (one hint serves single-pod and multi-pod meshes),
and so is an axis whose size does not divide the dim (the partition
rules' guard), so a local shard is always a whole block.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_STATE = threading.local()
_SCOPE_LOCK = threading.Lock()
_SCOPES = 0

#: the batch axes: pure data parallel over pods, then `data`
BATCH = ("pod", "data")


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def axis_size(name: str) -> int:
    """The size of mesh axis `name`; 1 off-mesh or for an axis the mesh
    lacks."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_of(tree):
    """The mesh of the first DTensor among `tree`'s leaves (nested dicts,
    lists and tuples), or None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            m = mesh_of(v)
            if m is not None:
                return m
        return None
    return tree.device_mesh if is_dtensor(tree) else None


def placements(shape, *spec, mesh=None) -> tuple:
    """DTensor placements of `spec` for a tensor of `shape` on `mesh`
    (the active mesh by default), through the partition rules' guard
    (`launch.sharding._guard`: axes the mesh lacks, and an entry whose
    axes do not divide its dim, are dropped)."""
    from repro_torch.launch.sharding import _guard, to_placements
    mesh = current_mesh() if mesh is None else mesh
    return tuple(to_placements(_guard(spec, shape, mesh), mesh))


@contextlib.contextmanager
def recording_hints():
    """Collect `(site, placements)` of every labelled hint and `local_map`
    input and output while the context is open (a list, in call order):
    what the placements test reads."""
    prev = getattr(_STATE, "record", None)
    _STATE.record = []
    try:
        yield _STATE.record
    finally:
        _STATE.record = prev


def _note(site, x):
    rec = getattr(_STATE, "record", None)
    if rec is not None and site and is_dtensor(x):
        rec.append((site, tuple(x.placements)))


def shard_hint(x, *spec, site: str = ""):
    """Redistribute a DTensor to `spec` on the active mesh; identity
    off-mesh or on a plain tensor. `site` labels the hint for
    `recording_hints`."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(tuple(x.shape), *spec, mesh=mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    _note(site, x)
    return x


def local_map(fn, args, in_specs, out_specs, out_shapes, *, site: str = "",
              partial: tuple = ()):
    """`fn(*args)` on each rank's local shards when an argument is a
    DTensor, else `fn(*args)` itself. `in_specs` gives a spec a tensor
    argument (None for any other argument): each DTensor argument is
    redistributed to it first (the hint of that site). `out_specs` gives
    a spec an output and `out_shapes` its global shape (for the guard);
    the outputs come back as DTensors laid out so. Autograd goes through:
    a `torch.autograd.Function` inside `fn` sees local tensors in its
    forward and backward alike. An argument whole over a mesh dim that
    splits another argument (a weight beside a batch-sharded activation)
    gets a gradient that is a partial sum over that dim.

    `partial` names the mesh axes over which the one output of `fn` is a
    partial sum (a contraction over a dim sharded there): each rank's
    part is one slice of a stack sharded over those axes, and the stack's
    sum is the output, so its backward hands each rank the whole
    gradient. The sum is reduced once, right here, in the output's dtype
    (one all-reduce, as XLA issues for the reference's row-parallel
    products), and comes back `Replicate` over those axes: every reader
    sees it whole, and the all-reduce's gradient passes through. A size-1
    axis is no partial sum and is not reduced."""
    if not any(is_dtensor(a) for a in args):
        # an alias of each input that takes a gradient: its uses inside
        # `fn` sum their gradients there first, as they do in the local
        # tensor of a DTensor, so a bf16 gradient rounds alike on both
        return fn(*(a.view_as(a) if getattr(a, "requires_grad", False)
                    else a for a in args))
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map as _lm
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    names = mesh.mesh_dim_names
    partial = tuple(a for a in partial
                    if a in names and mesh.size(names.index(a)) > 1)
    in_pl = tuple(None if s is None or not hasattr(a, "shape")
                  else placements(tuple(a.shape), *s, mesh=mesh)
                  for a, s in zip(args, in_specs))
    out_pl = tuple(None if s is None else placements(tuple(shp), *s,
                                                     mesh=mesh)
                   for s, shp in zip(out_specs, out_shapes))
    split = {i for pl in in_pl if pl is not None
             for i, q in enumerate(pl) if q.is_shard()}
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if i in split and q.is_replicate() else q
        for i, q in enumerate(pl)) for pl in in_pl)
    run = fn
    if partial:
        (pl,) = out_pl
        out_pl = (tuple(Shard(0) if n in partial else
                        Shard(q.dim + 1) if q.is_shard() else q
                        for n, q in zip(names, pl)),)

        def run(*a):
            return fn(*a)[None]
    single = len(out_pl) == 1
    # one output takes a list of placements; several, a tuple of them
    out = _lm(run, out_placements=list(out_pl[0]) if single else out_pl,
              in_placements=in_pl, in_grad_placements=grad_pl,
              device_mesh=mesh, redistribute_inputs=True)(*args)
    if partial:
        out = out.sum(dim=0)
        out = out.redistribute(mesh, [Replicate() if q.is_partial() else q
                                      for q in out.placements])
    rec = getattr(_STATE, "record", None)
    if rec is not None and site:
        rec.extend((f"{site}.in{i}", pl) for i, (a, pl) in
                   enumerate(zip(args, in_pl))
                   if pl is not None and is_dtensor(a))
    for i, o in enumerate((out,) if single else out):
        _note(f"{site}.out{i}" if site else "", o)
    return out


def assign(dst, src):
    """`dst[...] = src` in place (a decode cache's slot or state). On a
    DTensor `dst` each rank writes its own shard: `src` is laid out as
    `dst` first (a slice of what is whole, or a gather of the small `src`
    over an axis `dst` does not split), never `dst` gathered."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return dst
    from torch.distributed.tensor import DTensor, Replicate
    mesh = dst.device_mesh
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(mesh, dst.placements)
    with torch.no_grad():
        dst.to_local().copy_(src.to_local())
    return dst


@contextlib.contextmanager
def dtensor_scope(mesh):
    """The context of a forward or step over DTensors on `mesh`: the
    active mesh for the hints (the caller's, if one is active), and plain
    tensors made inside taken as replicated (`implicit_replication`).
    With `mesh` None, nothing."""
    if mesh is None:
        yield None
        return
    from torch.distributed.tensor.experimental import implicit_replication
    global _SCOPES
    active = current_mesh()
    # the flag of implicit_replication is global and reset on exit: set it
    # at the outermost scope of any thread (a remat recompute re-enters the
    # scope it ran in, on the autograd engine's thread for a CUDA tensor)
    with _SCOPE_LOCK:
        outer = _SCOPES == 0
        _SCOPES += 1
    inner = implicit_replication() if outer else contextlib.nullcontext()
    try:
        with use_mesh(active if active is not None else mesh) as m, inner:
            yield m
    finally:
        with _SCOPE_LOCK:
            _SCOPES -= 1
