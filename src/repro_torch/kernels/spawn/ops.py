"""Public wrapper of particle spawn: CUDA tensors go to the kernel
(`csrc/spawn.cu`, an order-preserving compaction of the events into the
dead slots), CPU tensors to the plain version (`ref.py`).

The kernel reads nothing back to the host, so a call never synchronises.
`spawn.launches` counts the kernels launched (four a call with C and M
above 0)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spawn.ref import spawn_ref

_SIGNATURES = {
    "jbp_spawn": (*[ctypes.c_void_p] * 14, ctypes.c_longlong,
                  ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.POINTER(ctypes.c_int), ctypes.c_void_p),
    "jbp_spawn_tile": ()}
_LIMIT = 1 << 31


def spawn(x, v, w, alive, new_x, new_v, new_w, mask):
    """x, w, alive: float32 [C]; v: float32 [C, 3]; new_x, new_w: float32
    [M]; new_v: float32 [M, 3]; mask: bool [M]. The k-th event of `mask`
    goes to the k-th dead slot (alive <= 0) in slot order, for k below the
    dead count; the rest are dropped. Returns (x, v, w, alive, dropped),
    out of place; dropped is an int64 scalar tensor."""
    if not x.is_cuda:
        return spawn_ref(x, v, w, alive, new_x, new_v, new_w, mask)
    _build.require_cuda("spawn", x, v, w, alive, new_x, new_v, new_w,
                        dtype=torch.float32)
    _build.require_cuda("spawn", mask, dtype=torch.bool)
    if mask.device != x.device:
        raise ValueError("spawn: all inputs must be on one CUDA device")
    C, M = x.shape[0], mask.shape[0]
    if (x.dim() != 1 or v.shape != (C, 3) or w.shape != (C,)
            or alive.shape != (C,) or mask.dim() != 1
            or new_x.shape != (M,) or new_v.shape != (M, 3)
            or new_w.shape != (M,)):
        raise ValueError("spawn: x, w, alive must be [C] and v [C, 3]; "
                         "new_x, new_w, mask [M] and new_v [M, 3]")
    if C >= _LIMIT or M >= _LIMIT:
        raise ValueError(f"spawn: the kernel takes C and M below 2**31, got "
                         f"C={C}, M={M}")
    lib = _build.load("spawn", _SIGNATURES)
    tile = lib.jbp_spawn_tile()
    n_scratch = -(-C // tile) + -(-M // tile) + 2 + min(C, M)
    out = [torch.empty_like(t) for t in (x, v, w, alive)]
    dropped = torch.empty((), dtype=torch.int64, device=x.device)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=x.device)
    launches = ctypes.c_int(0)
    with _build.on_device(x):
        rc = lib.jbp_spawn(*(t.data_ptr() for t in (
            x, v, w, alive, new_x, new_v, new_w, mask, *out, dropped,
            scratch)), n_scratch, C, M, ctypes.byref(launches),
            _build.stream_of(x))
    spawn.launches += launches.value
    _build.check(rc, "jbp_spawn")
    return (*out, dropped)


spawn.launches = 0
