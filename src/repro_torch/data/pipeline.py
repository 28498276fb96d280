"""Deterministic synthetic token pipeline with double-buffered host->device
prefetch: the port of the JAX package's `data/pipeline.py`.

`SyntheticTokens` is the JAX package's, verbatim (numpy only), so both
packages train on bit-identical batches. `Prefetcher` copies each batch to
the device from pinned host memory without blocking (`to_device`), where
the JAX package calls `jax.device_put`.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class SyntheticTokens:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, n_shards: int = 1, shard_id: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        if global_batch % n_shards:
            raise ValueError(
                f"global_batch={global_batch} is not divisible by "
                f"n_shards={n_shards} — every data shard needs an equal "
                f"local batch")
        self.local_batch = global_batch // n_shards
        self.seed = seed
        self.n_shards = n_shards
        self.shard_id = shard_id

    def batch_at(self, step: int) -> dict:
        """Materialize the local batch for `step` (stateless/replayable)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_id]))
        b, s = self.local_batch, self.seq
        # structured stream: per-sequence offset + small vocabulary walk
        base = rng.integers(0, self.vocab, size=(b, 1), dtype=np.int64)
        steps = rng.integers(-3, 4, size=(b, s), dtype=np.int64)
        toks = np.abs(base + np.cumsum(steps, axis=1)) % self.vocab
        tokens = toks.astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((b, 1), -100, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on `device`: for a CUDA device a
    pinned host copy and a non-blocking copy on the current stream."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


class Prefetcher:
    """Background-thread double buffering (overlap host batch gen + step).
    With `device`, each batch arrives as tensors there (`to_device`)."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0,
                 depth: int = 2, device: Optional[str] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._put = ((lambda b: b) if device is None
                     else (lambda b: to_device(b, device)))

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = source.batch_at(step)
                try:
                    self._q.put(self._put(batch), timeout=1.0)
                except queue.Full:
                    continue
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self) -> dict:
        return self._q.get()

    def stop(self):
        self._stop.set()
