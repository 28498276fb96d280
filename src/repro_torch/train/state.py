"""TrainState: params + AdamW moments + step (+ optional error-feedback
residuals for int8 gradient compression), the port of the JAX package's
`train/state.py`: `init_train_state` on one device, the state's shapes
(meta tensors) and its shardings over a mesh (`launch.sharding` specs, one
`NamedSharding` a leaf, in the state's own tree structure), and a step's
batch laid out over a mesh (`shard_batch`)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import init_opt_state
from repro_torch.optim.grad_compress import init_residuals


def _state(params, step: torch.Tensor, grad_compression: bool) -> dict:
    state = {"params": params, "opt": init_opt_state(params), "step": step}
    if grad_compression:
        state["residuals"] = init_residuals(params)
    return state


def init_train_state(cfg, seed: int = 0, *, grad_compression: bool = False,
                     device=None, params: Optional[dict] = None) -> dict:
    """{"params", "opt": {"m", "v"}, "step" (0-d int32), "residuals"?} on
    `device` (CUDA unless `device="cpu"`). The params are drawn from
    `seed` unless given (e.g. the JAX package's through
    `models.convert.params_from_numpy`)."""
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    return _state(params, torch.zeros((), dtype=torch.int32, device=dev),
                  grad_compression)


def train_state_shapes(cfg, *, grad_compression: bool = False) -> dict:
    """The state of `init_train_state` as meta tensors: shapes and dtypes,
    no storage."""
    return _state(M.param_shapes(cfg),
                  torch.zeros((), dtype=torch.int32, device="meta"),
                  grad_compression)


def train_state_shardings(cfg, mesh, *, grad_compression: bool = False):
    """NamedSharding tree for the full TrainState.

    Params: TP over `model` + ZeRO-3 over `data` (replicated across pods —
    DCN carries only gradients). Optimizer moments additionally shard over
    `pod` (ZeRO-1 across DCN): they are touched once per step, so the extra
    pod-axis reshard is one params-sized exchange — and it is what lets
    arctic-480b's 3.8 TB of f32 moments fit 16 GB chips on 2 pods."""
    from repro_torch.launch import sharding as S
    shapes = M.param_shapes(cfg)
    oshard = S.opt_sharding_tree(cfg, mesh, shapes)
    out: dict[str, Any] = {
        "params": S.param_sharding_tree(cfg, mesh, shapes),
        "opt": {"m": oshard, "v": oshard},
        "step": S.replicated(mesh),
    }
    if grad_compression:
        out["residuals"] = oshard
    return out


def shard_batch(batch, mesh) -> dict:
    """A step's inputs as DTensors on `mesh`, laid out over the batch axes
    ("pod", "data") on dim 0 (`launch.sharding.batch_sharding_tree`: a
    batch that does not divide stays whole): a plain tensor (the whole
    batch, the same on every rank) is cut to this rank's rows, with no
    communication; a DTensor stays as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.launch import sharding as S
    out = {}
    for k, sh in S.batch_sharding_tree(mesh, batch).items():
        v = batch[k]
        if sh is not None and not isinstance(v, DTensor):
            v = torch.as_tensor(v)
            v = distribute_tensor(v.to(_mesh_device(mesh)), mesh,
                                  sh.placements, src_data_rank=None)
        out[k] = v
    return out


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
