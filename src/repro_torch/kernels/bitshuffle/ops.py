"""Public wrappers of the byte shuffle: a CUDA tensor goes to the shuffle
kernel (`csrc/bitshuffle.cu`), a CPU tensor to the plain version
(`ref.py`). `shuffle`, `shuffle_block` and `unshuffle` have the API of the
JAX package's `kernels/bitshuffle/ops.py`; `shuffle_blocks` shuffles a
whole leaf's codec blocks in one launch, for the write path. Each takes a
rank's local bytes: a DTensor raises TypeError."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.bitshuffle.ref import (byte_shuffle_ref,
                                                byte_unshuffle_ref,
                                                shuffle_blocks_ref)

#: items per tile of the padded `shuffle` (the JAX wrapper's TILE_N)
TILE_N = 1024

_SIGNATURES = {"jbp_byte_shuffle": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)}


def _launch(data: torch.Tensor, block: int, itemsize: int,
            inverse: bool) -> torch.Tensor:
    """uint8 [n] on CUDA: each `block` bytes shuffled ([items, itemsize]
    -> [itemsize, items]) or, with `inverse`, unshuffled on its own."""
    _build.refuse_dtensor("byte shuffle", data)
    _build.require_cuda("byte shuffle", data, dtype=torch.uint8)
    out = torch.empty_like(data)
    lib = _build.load("bitshuffle", _SIGNATURES)
    with _build.on_device(data):
        rc = lib.jbp_byte_shuffle(data.data_ptr(), out.data_ptr(),
                                  data.shape[0], max(block, 1), itemsize,
                                  int(inverse), _build.stream_of(data))
    _build.check(rc, "jbp_byte_shuffle")
    return out


def shuffle(data: torch.Tensor, *, itemsize: int):
    """uint8 [n] -> (shuffled uint8 [n padded to itemsize*TILE_N], n)."""
    _build.refuse_dtensor("shuffle", data)
    n = data.shape[0]
    x = F.pad(data, (0, (-n) % (itemsize * TILE_N)))
    if not x.is_cuda:
        return byte_shuffle_ref(x, itemsize=itemsize), n
    out = _launch(x, x.shape[0], itemsize, False)
    shuffle.launches += 1
    return out, n


def shuffle_block(data: torch.Tensor, *, itemsize: int) -> torch.Tensor:
    """Shuffle exactly one codec block: uint8 [n] -> uint8 [n] with
    n % itemsize == 0 and no padding — bit-identical to the host
    `compression.byte_shuffle` on the same bytes."""
    _build.refuse_dtensor("shuffle_block", data)
    if data.shape[0] % itemsize:
        raise ValueError(
            f"shuffle_block needs len % itemsize == 0, got "
            f"{data.shape[0]} % {itemsize}")
    if not data.is_cuda:
        return byte_shuffle_ref(data, itemsize=itemsize)
    out = _launch(data, data.shape[0], itemsize, False)
    shuffle_block.launches += 1
    return out


def shuffle_blocks(data: torch.Tensor, *, block: int,
                   itemsize: int) -> torch.Tensor:
    """Shuffle every codec block of a leaf's bytes in one launch: uint8 [n]
    -> uint8 [n], each `block` bytes (the last run may be shorter) as
    `shuffle_block` would shuffle it alone. A run whose length is not a
    multiple of itemsize is copied unchanged, as the host codec leaves it,
    so the result equals the host `compression.byte_shuffle` applied block
    by block."""
    _build.refuse_dtensor("shuffle_blocks", data)
    if block <= 0 or itemsize <= 0:
        raise ValueError(f"shuffle_blocks needs block > 0 and itemsize > 0, "
                         f"got {block} and {itemsize}")
    if not data.is_cuda:
        return shuffle_blocks_ref(data, block=block, itemsize=itemsize)
    out = _launch(data, block, itemsize, False)
    shuffle_blocks.launches += 1
    return out


def unshuffle(data: torch.Tensor, n: int, *, itemsize: int) -> torch.Tensor:
    """Inverse of `shuffle`: uint8 [padded] -> the first n bytes."""
    _build.refuse_dtensor("unshuffle", data)
    if not data.is_cuda:
        return byte_unshuffle_ref(data, itemsize=itemsize)[:n]
    out = _launch(data, data.shape[0], itemsize, True)
    unshuffle.launches += 1
    return out[:n]


shuffle.launches = 0
shuffle_block.launches = 0
shuffle_blocks.launches = 0
unshuffle.launches = 0
