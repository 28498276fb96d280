"""Plain PyTorch byte shuffle — the transpose of the [n_items, itemsize]
byte matrix and its inverse, the oracle of the bitshuffle kernel."""
from __future__ import annotations


def byte_shuffle_ref(data, *, itemsize: int):
    n = data.shape[0] // itemsize
    return data.reshape(n, itemsize).t().reshape(-1)


def byte_unshuffle_ref(data, *, itemsize: int):
    n = data.shape[0] // itemsize
    return data.reshape(itemsize, n).t().reshape(-1)
