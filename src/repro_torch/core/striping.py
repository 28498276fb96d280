"""Lustre-style file striping over emulated OSTs.

A logical file is split into `stripe_size` stripes distributed round-robin
(raid0 pattern) over `stripe_count` object storage targets. OSTs are
emulated as object files in per-OST directories — the layout math, the
alignment behaviour, and the count x size performance tradeoff (paper Fig 9)
all reproduce structurally; a `getstripe()` introspection mirrors
`lfs getstripe` (paper Listing 1).

`StripedFile.write` flushes the per-OST segments of one logical write IN
PARALLEL (one flusher per OST touched — for large writes and whenever a
slow OST is involved; small all-fast writes stay inline), so a straggler
OST costs max(ost latencies), not their sum — the striping analogue of
the work-stealing aggregator pool. `mode="r"` opens an existing striped layout for reading
with cached per-OST handles (no re-open per segment) and a `logical_size`
recovered from the object files, so `getstripe()` works on readers too.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import threading
import time as _time
from typing import Optional

from repro_torch.core.darshan import MONITOR, open_file

# Below this size a multi-OST write is flushed inline: the segments are
# page-cache memcpys, so per-call thread create/join would cost more than
# the overlap buys. Slow (straggler) OSTs always take the parallel path.
PARALLEL_FLUSH_MIN_BYTES = 4 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class StripeConfig:
    stripe_count: int = 1
    stripe_size: int = 1 * 1024 * 1024          # bytes
    pattern: str = "raid0"

    def ost_of(self, stripe_idx: int) -> int:
        return stripe_idx % self.stripe_count

    def object_offset(self, stripe_idx: int) -> int:
        return (stripe_idx // self.stripe_count) * self.stripe_size


class OstPool:
    """A set of emulated OSTs rooted under `root/ost<k>/`."""

    def __init__(self, root, n_osts: int, *, slow_osts: Optional[dict] = None):
        self.root = pathlib.Path(root)
        self.n_osts = n_osts
        self.slow_osts = slow_osts or {}        # ost_id -> extra seconds/write
        for k in range(n_osts):
            (self.root / f"ost{k}").mkdir(parents=True, exist_ok=True)

    def object_path(self, ost: int, obj_name: str) -> pathlib.Path:
        return self.root / f"ost{ost}" / obj_name


def logical_size_of(pool: OstPool, name: str, cfg: StripeConfig) -> int:
    """Logical byte length of a striped layout recovered from the on-disk
    object sizes alone (stat-only — no object file is opened). raid0: the
    exact value is the max over OSTs of the logical span its object
    extends to. Shared by read-mode `StripedFile` and `jbpfsck`'s
    O(metadata) extent checks."""
    size = 0
    for k in range(cfg.stripe_count):
        p = pool.object_path(k, f"{name}.obj")
        if not p.exists():
            continue
        osz = p.stat().st_size
        if osz == 0:
            continue
        full, tail = divmod(osz, cfg.stripe_size)
        last = full - (0 if tail else 1)           # last stripe idx on k
        span = ((last * cfg.stripe_count + k) * cfg.stripe_size +
                (tail or cfg.stripe_size))
        size = max(size, span)
    return size


class StripedFile:
    """Write/read a logical byte stream striped across an OstPool.

    mode="w": creates/truncates the object files and accepts write()s.
    mode="r": opens an EXISTING striped layout — object files are never
    created or truncated, `logical_size` is recovered from their on-disk
    sizes, and read() reuses cached per-OST handles instead of re-opening
    an object file per segment.
    """

    def __init__(self, pool: OstPool, name: str, cfg: StripeConfig,
                 rank: int = 0, mode: str = "w"):
        if cfg.stripe_count > pool.n_osts:
            raise ValueError(
                f"stripe_count={cfg.stripe_count} exceeds the pool's "
                f"{pool.n_osts} OST(s) — a layout cannot stripe wider than "
                f"the targets that exist")
        if mode not in ("w", "r"):
            raise ValueError(f"mode must be 'w' or 'r', got {mode!r}")
        self.pool = pool
        self.name = name
        self.cfg = cfg
        self.rank = rank
        self._lock = threading.Lock()
        self.logical_size = 0
        self._handles = {}                      # ost -> write handle
        self._rhandles = {}                     # ost -> cached read handle
        self._mode = mode
        if mode == "w":
            for k in range(cfg.stripe_count):
                p = pool.object_path(k, f"{name}.obj")
                self._handles[k] = open_file(p, "wb", rank=rank)
        else:
            self.logical_size = logical_size_of(pool, name, cfg)

    # ----------------------------------------------------------------- write
    def write(self, data: bytes, offset: Optional[int] = None) -> int:
        """Stripe-split `data` at logical `offset` (default: append).

        The split is planned first, then the per-OST segment lists are
        flushed CONCURRENTLY (one flusher thread per OST touched, inline
        when only one OST is involved) — a slow OST no longer serialises
        the whole logical write behind it."""
        if self._mode != "w":
            raise ValueError(f"{self.name} is not open for writing")
        with self._lock:
            off = self.logical_size if offset is None else offset
            ss = self.cfg.stripe_size
            mv = memoryview(data)
            plans: dict[int, list] = {}        # ost -> [(obj_off, segment)]
            pos = 0
            while pos < len(data):
                stripe_idx = (off + pos) // ss
                intra = (off + pos) % ss
                take = min(ss - intra, len(data) - pos)
                ost = self.cfg.ost_of(stripe_idx)
                plans.setdefault(ost, []).append(
                    (self.cfg.object_offset(stripe_idx) + intra,
                     mv[pos:pos + take]))
                pos += take

            def flush_ost(ost, segments):
                h = self._handles[ost]
                slow = self.pool.slow_osts.get(ost, 0.0)
                for obj_off, seg in segments:
                    h.seek(obj_off)
                    if slow:
                        _time.sleep(slow)        # straggler-OST simulation
                    h.write(seg)

            items = sorted(plans.items())
            use_threads = len(items) > 1 and (
                len(data) >= PARALLEL_FLUSH_MIN_BYTES
                or any(self.pool.slow_osts.get(ost, 0.0) for ost, _ in items))
            if not use_threads:
                for ost, segments in items:
                    flush_ost(ost, segments)
            else:
                errors: list[BaseException] = []

                def runner(ost, segments):
                    try:
                        flush_ost(ost, segments)
                    except BaseException as e:   # noqa: BLE001
                        errors.append(e)

                threads = [threading.Thread(target=runner, args=it,
                                            name=f"jbp-ost-{it[0]}",
                                            daemon=True)
                           for it in items]
                for t in threads:
                    t.start()
                for t in threads:
                    # joining under the lock IS the contract: write()
                    # returns only after every OST flush landed, and the
                    # lock orders whole writes (no interleaved stripes)
                    t.join()   # jbplint: disable=JBP004
                if errors:
                    raise errors[0]
            self.logical_size = max(self.logical_size, off + len(data))
            return len(data)

    def flush(self):
        for h in self._handles.values():
            h.flush()

    def fsync(self):
        for h in self._handles.values():
            h.fsync()

    def close(self):
        for h in self._handles.values():
            h.close()
        self._handles.clear()
        for h in self._rhandles.values():
            h.close()
        self._rhandles.clear()

    # ------------------------------------------------------------------ read
    def _read_handle(self, ost: int):
        h = self._rhandles.get(ost)
        if h is None:
            p = self.pool.object_path(ost, f"{self.name}.obj")
            h = open_file(p, "rb", rank=self.rank)
            self._rhandles[ost] = h
        return h

    def read(self, offset: int, length: int) -> bytes:
        ss = self.cfg.stripe_size
        out = bytearray()
        pos = 0
        with self._lock:
            while pos < length:
                stripe_idx = (offset + pos) // ss
                intra = (offset + pos) % ss
                take = min(ss - intra, length - pos)
                h = self._read_handle(self.cfg.ost_of(stripe_idx))
                h.seek(self.cfg.object_offset(stripe_idx) + intra)
                out += h.read(take)
                pos += take
        return bytes(out)

    # ------------------------------------------------------------- introspect
    def getstripe(self) -> dict:
        """`lfs getstripe` analogue (paper Listing 1)."""
        objs = []
        for k in range(self.cfg.stripe_count):
            p = self.pool.object_path(k, f"{self.name}.obj")
            objs.append({"obdidx": k, "objid": f"{abs(hash(str(p))) & 0xffffffff:#x}",
                         "path": str(p),
                         "size": p.stat().st_size if p.exists() else 0})
        return {"lmm_stripe_count": self.cfg.stripe_count,
                "lmm_stripe_size": self.cfg.stripe_size,
                "lmm_pattern": self.cfg.pattern,
                "lmm_layout_gen": 0,
                "lmm_stripe_offset": 0,
                "objects": objs,
                "logical_size": self.logical_size}
