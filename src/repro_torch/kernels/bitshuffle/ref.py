"""Plain PyTorch byte shuffle — the transpose of the [n_items, itemsize]
byte matrix and its inverse, the oracle of the bitshuffle kernel."""
from __future__ import annotations

import torch


def byte_shuffle_ref(data, *, itemsize: int):
    n = data.shape[0] // itemsize
    return data.reshape(n, itemsize).t().reshape(-1)


def byte_unshuffle_ref(data, *, itemsize: int):
    n = data.shape[0] // itemsize
    return data.reshape(itemsize, n).t().reshape(-1)


def shuffle_blocks_ref(data, *, block: int, itemsize: int):
    """Every `block` bytes (the last run may be shorter) shuffled on its
    own; a run whose length is not a multiple of itemsize unchanged, as
    the host codec's `byte_shuffle` leaves it."""
    full = data.shape[0] // block * block
    head, tail = data[:full], data[full:]
    if block % itemsize == 0:
        head = head.reshape(-1, block // itemsize, itemsize).transpose(1, 2)
    if tail.shape[0] % itemsize == 0:
        tail = byte_shuffle_ref(tail, itemsize=itemsize)
    return torch.cat([head.reshape(-1), tail])
