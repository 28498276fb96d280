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
    forward and backward alike.

    An argument whole over a mesh dim that splits another argument or an
    output (a weight beside a batch-sharded activation, an activation
    beside a column-parallel weight, the kv heads each rank takes its own
    of) gets a gradient that is a partial sum over that dim. Over `model`
    it is reduced where the activation is read whole (`reduce_grad`), or
    by DTensor at its producer. A weight gathered whole over a batch axis
    here (the ZeRO-3 gather: it lies sharded there) hands its partial sum
    back as it is, where the gather's own backward would reduce-scatter it
    at every use: a layer's weights are reduced together when its
    backward ends (`reduce_grads_once`), the tables once a step
    (`train.step`).

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
    split = {i for pl in in_pl + out_pl if pl is not None
             for i, q in enumerate(pl) if q.is_shard()}
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if i in split and q.is_replicate() else q
        for i, q in enumerate(pl)) for pl in in_pl)
    args = tuple(_gather_keep_partial(a, pl, gpl)
                 for a, pl, gpl in zip(args, in_pl, grad_pl))
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


class _KeepPartial(torch.autograd.Function):
    """`x` redistributed to `placements`; the backward hands the gradient
    back partial over `keep` (the mesh dims it was gathered over), laid
    out as `x` over the others."""

    @staticmethod
    def forward(ctx, x, placements, keep):
        ctx.src, ctx.keep = tuple(x.placements), keep
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        want = tuple(q if i in ctx.keep else s for i, (q, s) in
                     enumerate(zip(g.placements, ctx.src)))
        if want != tuple(g.placements):
            g = g.redistribute(g.device_mesh, want)
        return g, None, None


def _gather_keep_partial(a, pl, grad_pl):
    """Argument `a` of `local_map` in its placements `pl`: where it is
    gathered whole over a batch axis whose gradient is a partial sum
    (`grad_pl`), through `_KeepPartial`, so that sum reaches `a`'s
    producer unreduced; else as it is (local_map redistributes it)."""
    if pl is None or not is_dtensor(a) or not a.requires_grad:
        return a
    names = a.device_mesh.mesh_dim_names
    keep = tuple(i for i, (s, q, g) in enumerate(zip(a.placements, pl,
                                                     grad_pl))
                 if names[i] in BATCH and s.is_shard() and q.is_replicate()
                 and g.is_partial())
    return _KeepPartial.apply(a, pl, keep) if keep else a


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the
    mesh dims `dims` where it is a partial sum (DTensor's
    Partial -> Replicate), in its own dtype."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        if not is_dtensor(g):
            return g, None
        want = tuple(Replicate() if i in ctx.dims and q.is_partial() else q
                     for i, q in enumerate(g.placements))
        if want != tuple(g.placements):
            g = g.redistribute(g.device_mesh, want)
        return g, None


def reduce_grad(x):
    """`x` itself, its gradient reduced once here: the backward twin of
    `local_map(partial=)`. An activation read whole over `model` by
    products that split their weights over it (q, k and v of one normed
    input; an FFN's gate and up; the Mamba2 projections; the
    vocab-parallel unembedding; the kv heads each rank takes its own of)
    gets a partial sum over `model` from each reader; autograd adds them
    as they are, and this all-reduces their sum once, in the gradient's
    dtype, as XLA all-reduces the cotangent of the reference's einsums.
    `layers.rms_norm` puts it on every normed output, which is what those
    products read. Its producer then sees it whole over `model` (without
    this, DTensor reduces it wherever the producer's layout asks: a
    reduce-scatter and a later all-gather). A gradient that is not a
    partial sum passes as it is; the batch axes are left to the train
    step; a size-1 axis is not reduced; a plain tensor, or one that takes
    no gradient, is returned as it is."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    mesh = x.device_mesh
    dims = tuple(i for i, n in enumerate(mesh.mesh_dim_names)
                 if n not in BATCH and mesh.size(i) > 1)
    return _ReduceGrad.apply(x, dims) if dims else x


def reduce_partials(gs, want) -> list:
    """Gradients `gs` (DTensors, or None) reduced where they are partial
    sums, each laid out as its placements in `want` (None: as reduced).
    The local tensors of all those partial over the same mesh dims of
    size > 1 (and of one dtype) go in one flat buffer, all-reduced once a
    dim in their dtype, as XLA combines the reference's gradient
    reductions; a partial sum over a size-1 dim is its value. A gradient
    laid out sharded is then a local slice of the reduced sum: an
    all-reduce and a slice, not a reduce-scatter, because torch 2.11's
    gloo has no `reduce_scatter_tensor_coalesced` for CUDA tensors (under
    `TORCH_DISTRIBUTED_DEBUG=DETAIL` it refuses it) and the ranks that
    share one card run on gloo."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    gs = list(gs)
    groups: dict = {}
    for i, g in enumerate(gs):
        if g is None:
            continue
        mesh = g.device_mesh
        dims = tuple(d for d, q in enumerate(g.placements)
                     if q.is_partial() and mesh.size(d) > 1)
        groups.setdefault((dims, g.dtype), []).append(i)
    local = {i: gs[i].to_local() for idx in groups.values() for i in idx}
    for (dims, _), idx in groups.items():
        if not dims:
            continue
        mesh = gs[idx[0]].device_mesh
        buf = torch.cat([local[i].reshape(-1) for i in idx])
        for d in dims:
            buf = funcol.wait_tensor(funcol.all_reduce(buf, "sum",
                                                       (mesh, d)))
        for i, part in zip(idx, buf.split([local[i].numel() for i in idx])):
            local[i] = part.view(local[i].shape)
    out = []
    for i, (g, pl) in enumerate(zip(gs, want)):
        if g is not None:
            mesh = g.device_mesh
            red = [Replicate() if q.is_partial() and mesh.size(d) > 1 else q
                   for d, q in enumerate(g.placements)]
            g = DTensor.from_local(local[i], mesh, red, run_check=False,
                                   shape=g.shape, stride=g.stride())
            if pl is not None and tuple(g.placements) != tuple(pl):
                g = g.redistribute(mesh, pl)
            loc = g.to_local()
            if loc.untyped_storage().nbytes() > loc.nbytes:
                # a view into the reduced buffer (a shard or one leaf of
                # it): copied, so the buffer is freed
                g = DTensor.from_local(loc.clone(), mesh, g.placements,
                                       run_check=False, shape=g.shape,
                                       stride=g.stride())
        out.append(g)
    return out


class _ReduceGradsOnce(torch.autograd.Function):
    """Identity forward on DTensors; the backward, which autograd runs
    once every output's gradient is in, reduces them together
    (`reduce_partials`), each laid out as its input."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.set_materialize_grads(False)
        ctx.src = [tuple(x.placements) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return tuple(reduce_partials(gs, ctx.src))


def reduce_grads_once(xs) -> list:
    """`xs` themselves, their gradients reduced together once all are in:
    a layer's weights, whose gradients come back from their ZeRO-3
    gathers (`local_map`) as partial sums over the batch axes, are
    all-reduced in one flat buffer when the layer's backward ends and
    laid out as the weights, as XLA all-reduces the tuple of a layer's
    weight gradients. So no more than one layer's gradients are ever
    whole over the batch axes. Plain tensors, tensors that take no
    gradient, and a mesh of size-1 dims only are returned as they are."""
    xs = list(xs)
    pick = [i for i, x in enumerate(xs) if is_dtensor(x) and x.requires_grad
            and any(n > 1 for n in x.device_mesh.shape)]
    if pick:
        for i, y in zip(pick, _ReduceGradsOnce.apply(*(xs[i]
                                                       for i in pick))):
            xs[i] = y
    return xs


def full_values(xs) -> list:
    """The full values of 0-d tensors as plain tensors: a DTensor partial
    over some mesh dims is reduced with the others in one all-reduce a
    mesh dim (each value counted once: a value whole over a dim is taken
    from that dim's first rank), where `full_tensor` issues one a value
    and dim. Plain tensors, and DTensors partial over no dim of size > 1,
    come back as their local values."""
    from torch.distributed.tensor import DTensor
    xs = list(xs)
    mesh = next((x.device_mesh for x in xs if is_dtensor(x)), None)
    if mesh is None:
        return xs
    dims = [i for i in range(mesh.ndim) if mesh.size(i) > 1
            and any(is_dtensor(x) and x.placements[i].is_partial()
                    for x in xs)]
    if any(is_dtensor(x) and (x.ndim or any(q.is_shard()
                                            for q in x.placements))
           for x in xs):
        raise ValueError("full_values takes 0-d tensors")
    local = [x.to_local() if is_dtensor(x) else x for x in xs]
    if not dims:
        return local
    import torch.distributed._functional_collectives as funcol
    dtype = local[0].dtype
    v = torch.stack([t.to(dtype) for t in local])
    coord = mesh.get_coordinate()
    for i in dims:
        # a value whole over dim i is added once, from the dim's first rank
        keep = torch.tensor([(isinstance(x, DTensor)
                              and x.placements[i].is_partial())
                             or coord[i] == 0 for x in xs], device=v.device)
        v = funcol.wait_tensor(funcol.all_reduce(
            torch.where(keep, v, torch.zeros_like(v)), "sum", (mesh, i)))
    return [v[j].to(t.dtype) for j, t in enumerate(local)]


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
