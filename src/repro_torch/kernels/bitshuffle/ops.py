"""Public wrappers of the byte shuffle: a CUDA tensor goes to the transpose
kernel (`csrc/bitshuffle.cu`), a CPU tensor to the plain version
(`ref.py`). Same API as the JAX package's `kernels/bitshuffle/ops.py`."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.bitshuffle.ref import (byte_shuffle_ref,
                                                byte_unshuffle_ref)

#: items per tile of the padded `shuffle` (the JAX wrapper's TILE_N)
TILE_N = 1024

_SIGNATURES = {"jbp_byte_transpose": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p)}


def _transpose(data: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """uint8 [rows*cols] row-major [rows, cols] -> [cols, rows], on CUDA."""
    _build.require_cuda("byte transpose", data, dtype=torch.uint8)
    out = torch.empty_like(data)
    lib = _build.load("bitshuffle", _SIGNATURES)
    with torch.cuda.device(data.device):
        rc = lib.jbp_byte_transpose(data.data_ptr(), out.data_ptr(), rows,
                                    cols, _build.stream_of(data))
    _build.check(rc, "jbp_byte_transpose")
    return out


def shuffle(data: torch.Tensor, *, itemsize: int):
    """uint8 [n] -> (shuffled uint8 [n padded to itemsize*TILE_N], n)."""
    n = data.shape[0]
    x = F.pad(data, (0, (-n) % (itemsize * TILE_N)))
    if not x.is_cuda:
        return byte_shuffle_ref(x, itemsize=itemsize), n
    out = _transpose(x, x.shape[0] // itemsize, itemsize)
    shuffle.launches += 1
    return out, n


def shuffle_block(data: torch.Tensor, *, itemsize: int) -> torch.Tensor:
    """Shuffle exactly one codec block: uint8 [n] -> uint8 [n] with
    n % itemsize == 0 and no padding — bit-identical to the host
    `compression.byte_shuffle` on the same bytes."""
    if data.shape[0] % itemsize:
        raise ValueError(
            f"shuffle_block needs len % itemsize == 0, got "
            f"{data.shape[0]} % {itemsize}")
    if not data.is_cuda:
        return byte_shuffle_ref(data, itemsize=itemsize)
    out = _transpose(data, data.shape[0] // itemsize, itemsize)
    shuffle_block.launches += 1
    return out


def unshuffle(data: torch.Tensor, n: int, *, itemsize: int) -> torch.Tensor:
    """Inverse of `shuffle`: uint8 [padded] -> the first n bytes."""
    if not data.is_cuda:
        return byte_unshuffle_ref(data, itemsize=itemsize)[:n]
    out = _transpose(data, itemsize, data.shape[0] // itemsize)
    unshuffle.launches += 1
    return out[:n]


shuffle.launches = 0
shuffle_block.launches = 0
unshuffle.launches = 0
