"""SST-style streaming engine — the paper's stated future work (§VI):
"the ADIOS2 SST engine enables the direct connection of data producers and
consumers ... for in-situ processing, analysis, and visualization".

`SstStream` is the JBP-native analogue: a bounded in-memory step queue with
the same put()/step protocol as BpWriter, so a Series can stream iterations
to an in-process consumer (live diagnostics, training-metric dashboards)
WITHOUT touching the filesystem. Back-pressure blocks the producer when the
consumer lags (queue_depth), exactly like SST's reliable mode.

Tee-to-disk: pass `tee=AsyncBpWriter(...)` and every streamed step is ALSO
forwarded chunk-for-chunk into the write pipeline from the same snapshot —
streaming consumers and BP4 persistence share one capture of the data, and
because the tee's end_step is non-blocking the producer still only pays the
in-memory assembly cost. `close()` drains and closes the tee, so a closed
stream implies the teed series is durable.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np

# consumers blocked in steps() re-check the closed flag at this cadence, so
# close() never has to force a sentinel through a full queue
_POLL_S = 0.05


class SstStream:
    def __init__(self, queue_depth: int = 4, *, tee=None):
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._step: Optional[int] = None
        self._pending: dict[str, dict] = {}
        self._closed = threading.Event()
        self._tee = tee                  # BpWriter-protocol sink (async ok)

    # ------------------------------------------------------------- producer
    def begin_step(self, step: int):
        if self._step is not None:
            raise RuntimeError(f"begin_step({step}) while step "
                               f"{self._step} is still open — call "
                               f"end_step() first")
        self._step = step
        self._pending = {}

    def put(self, name: str, array: np.ndarray, *, global_shape=None,
            offset=None, rank: int = 0):
        if self._step is None:
            raise RuntimeError(
                "put() outside a step — call begin_step() first")
        a = np.asarray(array)
        var = self._pending.setdefault(name, {
            "dtype": a.dtype, "global_shape": tuple(global_shape or a.shape),
            "chunks": []})
        var["chunks"].append((tuple(offset or (0,) * a.ndim), rank, a))

    def end_step(self):
        """Assemble the step's variables and hand them to the consumer
        (blocks when the consumer is queue_depth behind). The same snapshot
        feeds the tee writer, if any."""
        step = self._step
        out: dict[str, np.ndarray] = {}
        for name, var in self._pending.items():
            g = np.zeros(var["global_shape"], var["dtype"])
            for off, _rank, arr in var["chunks"]:
                sl = tuple(slice(o, o + s) for o, s in zip(off, arr.shape))
                g[sl] = arr
            out[name] = g
        tee_exc = None
        if self._tee is not None:
            try:
                self._tee.begin_step(step)
                for name, var in self._pending.items():
                    for off, rank, arr in var["chunks"]:
                        self._tee.put(name, arr,
                                      global_shape=var["global_shape"],
                                      offset=off, rank=rank)
                self._tee.end_step()
            except BaseException as e:     # noqa: BLE001
                tee_exc = e                # persistence failed — stream on
        self._q.put((step, out))
        self._step = None
        self._pending = {}
        if tee_exc is not None:
            # the consumer got its step and the stream stays usable; the
            # producer still learns that persistence is broken
            raise tee_exc

    def close(self):
        """End the stream. ALWAYS completes, even with a full queue and no
        consumer draining: the sentinel is best-effort (a blocking put here
        deadlocked producers whose consumer had died) — consumers blocked in
        steps() observe the closed flag by polling instead."""
        self._closed.set()
        try:
            self._q.put_nowait(None)       # wake an already-waiting consumer
        except queue.Full:
            pass                           # steps() polls _closed; no deadlock
        if self._tee is not None:
            # AsyncBpWriter.close() drains, always completes its cleanup
            # (thread + file handles) and only then raises any write error
            self._tee.close()

    # ------------------------------------------------------------- consumer
    def steps(self, timeout: Optional[float] = None) -> Iterator[tuple]:
        """Yield (step, vars) until the stream closes. `timeout` bounds the
        idle wait between steps: when nothing arrives for `timeout` seconds
        the iterator ENDS (it does not leak queue.Empty), so a consumer can
        bail out of a stalled producer cleanly."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed.is_set() and self._q.empty():
                return
            wait = _POLL_S
            if deadline is not None:
                wait = min(wait, deadline - time.monotonic())
                if wait <= 0:
                    return                 # idle past timeout -> clean end
            try:
                item = self._q.get(timeout=max(wait, 1e-3))
            except queue.Empty:
                continue
            if item is None:
                return
            yield item
            if timeout is not None:        # idle timeout is per-step
                deadline = time.monotonic() + timeout


def attach_consumer(stream: SstStream, fn: Callable[[int, dict], Any],
                    *, daemon: bool = True) -> threading.Thread:
    """Run `fn(step, vars)` on every streamed step in a background thread.

    A raising `fn` must not wedge the pipeline: the producer blocks in
    `end_step` whenever the bounded queue is full, so a silently-dead
    consumer thread would deadlock it. On the first exception the error is
    recorded on the returned thread (`t.error`), later steps are DRAINED
    and discarded until the stream closes, and the caller discovers the
    failure after join() by checking `t.error`.
    """
    def loop():
        try:
            for step, data in stream.steps():
                fn(step, data)
        except BaseException as e:         # noqa: BLE001 — surfaced via t.error
            t.error = e
            for _ in stream.steps():       # keep the producer unblocked
                pass

    t = threading.Thread(target=loop, daemon=daemon)
    t.error = None
    t.start()
    return t
