"""Production mesh construction on `torch.distributed`: the port of the
JAX package's `launch/mesh.py`.

A mesh is a `DeviceMesh` with named dims, one device a rank (row-major
over the mesh, as JAX numbers the devices of `Mesh(devices.reshape(...))`).
`AbstractMesh` is the mesh's shape alone, axis names and sizes with no
process group, on which the partition rules (`launch.sharding`) reason
about a 256- or 512-device mesh, as the reference's run on
`jax.sharding.AbstractMesh`. Defined as functions: importing this module
touches no device and no process group.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape: `shape[i]` devices along the dim named
    `mesh_dim_names[i]` (the attribute names of `DeviceMesh`)."""
    shape: tuple
    mesh_dim_names: tuple

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "mesh_dim_names", tuple(self.mesh_dim_names))
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.mesh_dim_names} differ in length")


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(shape, axes, *, device_type=None):
    """A `DeviceMesh` of `shape` with dims named `axes` over the process
    group's ranks, on `device_type` ("cuda" unless "cpu" is asked for).
    With no process group and a mesh of one device, brings up a one-rank
    group itself (nccl for CUDA, gloo for the CPU, on a `HashStore`), so a
    single-card caller needs no launcher; a larger mesh needs the group
    from `launch.distributed.initialize`. A gloo group's mesh on "cuda"
    (ranks that share one card) gets the functional all-gather that
    torch's gloo lacks (`launch.distributed.repair_gloo_cuda_gather`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    dev = resolve_device(device_type)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a {shape} mesh needs a process group of "
                f"{math.prod(shape)} ranks: call "
                f"launch.distributed.initialize() in each rank first")
        dist.init_process_group(_backend(dev.type), store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {dist.get_world_size()}")
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        # ranks sharing one card (nccl takes one rank a card)
        from repro_torch.launch.distributed import repair_gloo_cuda_gather
        repair_gloo_cuda_gather()
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512).

    Axes: `pod` (pure data-parallel replicas), `data` (batch + FSDP/ZeRO
    shards), `model` (tensor/expert parallel). Raises unless the process
    group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_debug_mesh(*, multi_pod: bool = False, n_devices=None,
                    device_type=None):
    """Small-device-count mesh with the same axis names (tests / CI) over
    `n_devices` ranks, by default the process group's."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    if multi_pod:
        if n % 2 or n < 8:
            raise ValueError(f"multi-pod debug mesh needs an even device "
                             f"count >= 8, got {n}")
        shape = (2, n // 4, 2)
        axes = ("pod", "data", "model")
    else:
        if n % 2:
            raise ValueError(
                f"debug mesh needs an even device count, got {n}")
        shape = (n // 2, 2)
        axes = ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def mesh_summary(mesh) -> dict:
    return {"axis_names": list(mesh.mesh_dim_names),
            "shape": [int(s) for s in mesh.shape],
            "n_devices": int(math.prod(mesh.shape))}
