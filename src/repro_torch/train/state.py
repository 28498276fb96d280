"""TrainState: params + AdamW moments + step (+ optional error-feedback
residuals for int8 gradient compression), the port of the JAX package's
`train/state.py` on one device (the mesh shardings come with the port's
mesh layer)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import init_opt_state
from repro_torch.optim.grad_compress import init_residuals


def init_train_state(cfg, seed: int = 0, *, grad_compression: bool = False,
                     device=None, params: Optional[dict] = None) -> dict:
    """{"params", "opt": {"m", "v"}, "step" (0-d int32), "residuals"?} on
    `device` (CUDA unless `device="cpu"`). The params are drawn from
    `seed` unless given (e.g. the JAX package's through
    `models.convert.params_from_numpy`)."""
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if grad_compression:
        state["residuals"] = init_residuals(params)
    return state
