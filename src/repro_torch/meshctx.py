"""Ambient mesh for in-model sharding hints: the port of the JAX package's
`meshctx.py` on `torch.distributed`'s `DeviceMesh` and DTensor.

Model code calls `shard_hint(x, 'axis', ...)` to constrain intermediate
layouts (e.g. the MoE dispatch buffer). Outside a mesh context (unit tests,
single-device runs), and on a plain tensor, hints are no-ops, so the same
code runs everywhere. On a DTensor a hint redistributes it to the
placements of the spec (`launch.sharding.to_placements`).
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


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


def shard_hint(x, *spec):
    """Redistribute a DTensor to `spec` on the active mesh; identity
    off-mesh or on a plain tensor. Axis names absent from the active mesh
    are dropped (lets the same hint serve single-pod and multi-pod
    meshes)."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import P, to_placements
    names = mesh.mesh_dim_names

    def _filter(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    fspec = P(*[_filter(e) for e in spec])
    return x.redistribute(mesh, to_placements(fspec, mesh))
