"""Zero-copy shared-memory chunk transport for the parallel write plane.

The port's own copy of the JAX package's transport (numpy only, so
unchanged but for its imports). `ParallelBpWriter`'s pickle transport
ships every chunk to its writer process by pickling the ndarray down a
`multiprocessing` queue: that is one serialize pass plus a pipe write in
the coordinator and a pipe read plus a deserialize pass in the worker —
three-plus copies of every payload byte, all through 64 KiB pipe
windows. On multi-MiB chunks the pickle copy, not the disk, is what caps
aggregate throughput (Huebl et al. on in-transit data reduction).

`ShmRing` replaces that with ONE memcpy into a per-worker POSIX
shared-memory ring buffer:

    coordinator                            worker w
    -----------                            --------
    write_array(arr)                       view(hdr) -> ndarray over the
      -> bump-alloc a pow2 slot                ring's mmap (ZERO copies;
      -> single np.copyto into the ring        compression reads straight
      -> ShmHeader(offset, dtype, shape)       from shared pages)
         down the control queue            ...ack "prepared"
    free(offset)  <------- the ack is the free-list: slots are
                           reclaimed only after the step resolved

Allocation is a classic single-producer ring: slots are powers of two
(>= `min_slot`), allocated at `head`, freed strictly FIFO at the tail
(the deque of live segments). When a slot would run off the end of the
ring a pad segment covers the wasted tail and allocation wraps to 0 —
pads are reclaimed transparently when the FIFO free sweeps past them.
A payload that cannot fit (oversized, or the ring is full of in-flight
steps) gets `None` back and the caller falls back to the pickle path —
the transport degrades, it never blocks or fails.

Crash semantics are the write plane's own: slot contents are stable from
`write_array` until `free`, and the coordinator frees only when the
step's ack arrived (prepared OR error) or the step aborted. A worker
SIGKILLed while a slot is in flight therefore corrupts nothing — the
step was never committed, exactly a torn shard — and the ring itself is
unlinked by the owner's `close()`/finalizer, so no /dev/shm leak even on
abnormal exit.
"""
from __future__ import annotations

import secrets
import threading
from collections import deque
from multiprocessing import shared_memory
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.dxt import TRACER
from repro_torch.core.metrics import METRICS

MIN_SLOT = 4096                      # one page: below this, pickle wins anyway
DEFAULT_RING_BYTES = 64 * 1024 ** 2  # per-worker ring; ~2 steps of 8x4MiB ranks

# serializes the attach-side resource-tracker register suppression below:
# two threads attaching concurrently (jbpd clients attach per-connection
# response rings) would otherwise race the save/restore and could leave the
# no-op register installed process-wide
_ATTACH_LOCK = threading.Lock()


class ShmHeader(NamedTuple):
    """What travels down the control queue INSTEAD of the ndarray."""
    offset: int          # byte offset of the slot in the ring
    nbytes: int          # payload bytes (slot is the pow2 roundup)
    dtype: str           # numpy dtype.str
    shape: tuple         # chunk shape


def validate_transport(transport: str) -> str:
    """The one accepted-spelling check for every constructor that takes a
    `transport=` (Series, WriterPlane, ParallelBpWriter) — a transport the
    plane does not speak must fail identically everywhere."""
    if transport not in ("shm", "pickle"):
        raise ValueError(f"unknown transport {transport!r} "
                         "(expected 'shm' or 'pickle')")
    return transport


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


class ShmRing:
    """Power-of-two-slot ring buffer in one POSIX shared-memory segment.

    One ring per writer worker; the COORDINATOR is the only allocator
    (`alloc`/`write_array`/`free`), the WORKER only maps read views
    (`view`). Frees must arrive in allocation order — they do, because
    the plane keeps at most one step in flight per worker and a step's
    slots are allocated and resolved together.
    """

    def __init__(self, capacity: int = DEFAULT_RING_BYTES, *,
                 name: Optional[str] = None, create: bool = True,
                 min_slot: int = MIN_SLOT):
        if create:
            capacity = _pow2_ceil(max(int(capacity), min_slot))
            name = name or f"jbp-ring-{secrets.token_hex(8)}"
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=capacity)
            # prefault: touch one byte per page so tmpfs allocates the whole
            # ring NOW (ring creation precedes the ready handshake, off the
            # step path) — otherwise the first step of every fresh ring pays
            # a page fault per 4 KiB of payload and the transport benchmarks
            # its own cold start instead of its steady state
            np.frombuffer(self._shm.buf, np.uint8)[::4096] = 0
        else:
            # CPython < 3.13 registers ATTACHED segments with the resource
            # tracker too. Spawned workers share the coordinator's tracker,
            # so an attach-register is a harmless set re-add — but a worker
            # must NOT unregister (that would strip the owner's entry and
            # defeat abnormal-exit cleanup) and must not let a private
            # tracker unlink the ring at worker exit. Suppressing the
            # register during attach is the one behavior that is correct in
            # both topologies; the owner's registration stays authoritative.
            from multiprocessing import resource_tracker
            with _ATTACH_LOCK:
                real_register = resource_tracker.register
                resource_tracker.register = lambda *a, **k: None
                try:
                    self._shm = shared_memory.SharedMemory(name=name)
                finally:
                    resource_tracker.register = real_register
            # populate this process's page table for the whole mapping (a
            # read suffices: the owner already allocated the pages) — the
            # attach side of the same cold-start avoidance as above
            int(np.frombuffer(self._shm.buf, np.uint8)[::4096].sum())
        self.capacity = self._shm.size
        self.min_slot = min_slot
        self._owner = create
        self._head = 0
        # live segments in allocation order: (offset, slot_len, is_pad)
        self._segments: deque[tuple[int, int, bool]] = deque()
        self._unlinked = False

    @classmethod
    def attach(cls, name: str, *, min_slot: int = MIN_SLOT) -> "ShmRing":
        """Map an EXISTING ring by name from a process that is NOT a child
        of the owner — the jbpd client topology: the daemon owns per-client
        response rings, and an unrelated local process attaches to read its
        responses. The same register-suppression as the worker attach path
        applies (an unrelated process has its own resource tracker, which
        must not unlink the daemon's ring when the client exits); the
        owner's registration stays the abnormal-exit cleanup. Raises
        FileNotFoundError when no such segment exists (daemon gone or the
        ring already unlinked) — callers fall back to socket framing."""
        return cls(name=name, create=False, min_slot=min_slot)

    @property
    def name(self) -> str:
        return self._shm.name

    # ------------------------------------------------------------ coordinator
    def slot_len(self, nbytes: int) -> int:
        return _pow2_ceil(max(int(nbytes), self.min_slot))

    def free_bytes(self) -> int:
        return self.capacity - sum(s for _, s, _ in self._segments)

    def alloc(self, nbytes: int) -> Optional[int]:
        """Reserve a slot for `nbytes`; returns its offset, or None when it
        cannot fit (caller falls back to pickling the array)."""
        slot = self.slot_len(nbytes)
        if slot > self.capacity:
            return None
        if not self._segments:
            self._head = 0                      # empty ring: defragment free
        tail = self._segments[0][0] if self._segments else None
        if tail is None or tail < self._head:
            # live region (if any) is [tail, head): free space is the tail
            # end [head, capacity) then the wrapped start [0, tail)
            if self._head + slot <= self.capacity:
                off, self._head = self._head, self._head + slot
                self._segments.append((off, slot, False))
                return off
            if tail is not None and slot < tail:
                # wrap: pad out the unusable tail so FIFO frees stay aligned
                self._segments.append(
                    (self._head, self.capacity - self._head, True))
                self._segments.append((0, slot, False))
                self._head = slot
                return 0
            return None
        # live region wraps [tail, capacity) + [0, head) — or the ring is
        # exactly full (tail == head): free space is [head, tail), kept
        # strictly short of tail so full never aliases empty
        if self._head + slot < tail:
            off, self._head = self._head, self._head + slot
            self._segments.append((off, slot, False))
            return off
        return None

    def write_array(self, arr: np.ndarray) -> Optional[ShmHeader]:
        """One memcpy of `arr` into a fresh slot; the returned header is all
        that crosses the process boundary. None = fall back to pickle."""
        off = self.alloc(arr.nbytes)
        if off is None:
            return None
        t0 = (TRACER.now() if TRACER.enabled or METRICS.enabled else 0.0)
        dst = np.ndarray(arr.shape, dtype=arr.dtype,
                         buffer=self._shm.buf, offset=off)
        np.copyto(dst, arr)
        del dst                                 # release the exported buffer
        if TRACER.enabled:
            TRACER.record(0, self.name, "shm_write", off, arr.nbytes,
                          t0, TRACER.now())
        if METRICS.enabled:
            METRICS.observe("shm_write", TRACER.now() - t0,
                            nbytes=arr.nbytes, key=self.name)
        return ShmHeader(off, arr.nbytes, arr.dtype.str, tuple(arr.shape))

    def free(self, offset: int):
        """Release the OLDEST live slot (must match `offset`) plus any pad
        segments in front of it — the FIFO discipline of the ack free-list."""
        while self._segments and self._segments[0][2]:
            self._segments.popleft()
        if not self._segments or self._segments[0][0] != offset:
            raise ValueError(
                f"out-of-order free: offset {offset} is not the ring tail "
                f"({self._segments[0][0] if self._segments else 'empty'})")
        self._segments.popleft()
        while self._segments and self._segments[0][2]:
            self._segments.popleft()
        if not self._segments:
            self._head = 0

    # ----------------------------------------------------------------- worker
    def view(self, hdr: ShmHeader) -> np.ndarray:
        """Read-only ndarray over the slot — compression reads shared pages
        directly, no copy. The view MUST be dropped before close()."""
        a = np.ndarray(hdr.shape, dtype=np.dtype(hdr.dtype),
                       buffer=self._shm.buf, offset=hdr.offset)
        a.flags.writeable = False
        return a

    # --------------------------------------------------------------- lifetime
    def close(self):
        try:
            self._shm.close()
        except BufferError:
            # a live view pins the mmap; the fd still goes away with the
            # process, and the owner's unlink below is what matters
            pass

    def unlink(self):
        if self._unlinked:
            return
        self._unlinked = True
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        if self._owner:
            self.unlink()


def unlink_rings(rings):
    """Finalizer target: unlink every ring (idempotent, exception-free) —
    registered via `weakref.finalize` by ring owners so an abnormal exit
    (unhandled exception, GC of a leaked plane) still reclaims /dev/shm."""
    for r in rings:
        try:
            r.close()
            r.unlink()
        except Exception:                       # noqa: BLE001 — teardown
            pass
