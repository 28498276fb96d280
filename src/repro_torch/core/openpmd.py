"""openPMD data model (Series -> Iteration -> Mesh/ParticleSpecies ->
Record -> RecordComponent) over the JBP engine.

Follows the openPMD standard's structure and naming (basePath="/data/%T/",
meshesPath="meshes/", particlesPath="particles/") and the openPMD-api usage
protocol the paper describes in §III-A/B:

  * a Series is the root object spanning all iterations,
  * data accumulates in record components via store_chunk() and hits the
    engine only at series.flush() (single action for I/O efficiency),
  * once an iteration is closed it is never reopened,
  * store_chunk needs (local array, offset, global extent) per rank —
    exactly the information an MPI rank (or a device tensor) owns.

Group-based iteration encoding with steps: one BP directory, one engine
step per iteration (the paper's chosen memory strategy).

Async I/O: `Series(..., async_io=True)` swaps the sync BpWriter for an
`AsyncBpWriter` — `flush()` then only SNAPSHOTS the dirty record components
(deep copy) and enqueues the step on a bounded in-flight queue, returning
before compression or any filesystem write happens. The background pipeline
seals steps in flush order with the same crc'd md.idx protocol, so
durability semantics are unchanged: a flushed iteration is durable once its
index record is on disk, `Series.drain()` is the barrier that guarantees it
for every queued step, and `close()` implies `drain()`. The openPMD "chunks
stay unmodified until flush" contract thereby RELAXES to "until end of
flush()": the caller may reuse buffers as soon as flush returns.

Multi-process I/O: `Series(..., parallel_io=W)` swaps in the
`repro_torch.core.parallel_engine.ParallelBpWriter` — W REAL writer
processes, each owning one aggregated subfile, committed per step by a
rank-0 two-phase commit. Chunk bytes reach the workers through
per-worker shared-memory rings by default (`transport="shm"`; `"pickle"`
is the queue-serialization baseline). A tensor chunk is shuffled on its
device (with `device_compress`) or copied to host by the coordinator: only
numpy bytes cross to a worker, which never touches CUDA. The on-disk
series is read-compatible with every other engine.

Composition: `Series(..., parallel_io=W, async_commit=True)` puts a
bounded snapshot queue in FRONT of the parallel coordinator — `flush()`
returns after a deep-copy snapshot (a tensor cloned on its device) and
the whole two-phase commit (compression, subfile appends, shard votes,
md.idx seal) runs behind the producer; `drain()` is the durability
barrier, exactly as with `async_io`. The two flags are validated UP
FRONT: `async_io` names the single-process pipelined engine,
`async_commit` names the parallel plane's pipelined commit, and asking
for both planes at once (`async_io=True, parallel_io=W`) is a
`ValueError` pointing at the `async_commit` spelling rather than a
silently-ignored knob.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Optional

import numpy as np

from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig

OPENPMD_VERSION = "1.1.0"
BASE_PATH = "/data/%T/"
MESHES_PATH = "meshes/"
PARTICLES_PATH = "particles/"


class RecordComponent:
    def __init__(self, path: str, series: "Series"):
        self._path = path
        self._series = series
        self._dtype: Optional[np.dtype] = None
        self._global_extent: Optional[tuple] = None
        self._chunks: list[tuple[np.ndarray, tuple, int]] = []
        self.attributes: dict[str, Any] = {"unitSI": 1.0}
        self.codec: Optional[str] = None   # per-variable engine-codec override

    def reset_dataset(self, dtype, global_extent: tuple):
        from repro_torch.core import compression as _C
        self._dtype = _C.np_dtype(dtype)
        self._global_extent = tuple(int(x) for x in global_extent)
        return self

    def set_codec(self, spec: Optional[str]):
        """Override the engine codec for THIS component, e.g. "lossy:1e-4"
        for particle data while fields stay lossless. Validated now."""
        if spec is not None:
            from repro_torch.core import compression as _C
            _C.parse_codec(spec)
        self.codec = spec
        return self

    def store_chunk(self, array, offset: tuple, *, rank: int = 0):
        """Queue one rank's chunk. The referenced data must stay unmodified
        until flush() (openPMD contract). A tensor is kept as it is, on
        its device: with `Series(device_compress=True)` the engine
        byte-shuffles it there at flush and the host only runs the LZ
        stage."""
        from repro_torch.core import compression as _C
        a = array if _C.is_device_array(array) else np.asarray(array)
        if self._dtype is None:
            self.reset_dataset(a.dtype, a.shape)
        self._chunks.append((a, tuple(int(x) for x in offset), rank))
        self._series._dirty[self] = None
        return self

    def set_attribute(self, k: str, v):
        self.attributes[k] = v

    # -------- read side ------------------------------------------------------
    def load_chunk(self, offset: Optional[tuple] = None,
                   extent: Optional[tuple] = None) -> np.ndarray:
        step = int(self._path.split("/")[2])
        return self._series._reader().read_var(step, self._path, offset, extent)

    @property
    def shape(self):
        if self._global_extent is not None:
            return self._global_extent
        step = int(self._path.split("/")[2])
        return tuple(self._series._reader().var_info(step, self._path)["shape"])


class Record(dict):
    """A physical quantity; dict of RecordComponents (scalar: key ''). """

    SCALAR = ""

    def __init__(self, path: str, series: "Series"):
        super().__init__()
        self._path = path
        self._series = series
        self.attributes: dict[str, Any] = {"unitDimension": [0.0] * 7}

    def __getitem__(self, key) -> RecordComponent:
        if key not in self:
            comp_path = self._path if key == "" else f"{self._path}/{key}"
            super().__setitem__(key, RecordComponent(comp_path, self._series))
        return super().__getitem__(key)

    def set_attribute(self, k, v):
        self.attributes[k] = v


class Mesh(Record):
    def __init__(self, path, series):
        super().__init__(path, series)
        self.attributes.update({
            "geometry": "cartesian", "dataOrder": "C", "axisLabels": ["x"],
            "gridSpacing": [1.0], "gridGlobalOffset": [0.0], "gridUnitSI": 1.0,
        })


class ParticleSpecies(dict):
    def __init__(self, path: str, series: "Series"):
        super().__init__()
        self._path = path
        self._series = series
        self.attributes: dict[str, Any] = {}

    def __getitem__(self, key) -> Record:
        if key not in self:
            super().__setitem__(key, Record(f"{self._path}/{key}", self._series))
        return super().__getitem__(key)


class _Container(dict):
    def __init__(self, factory):
        super().__init__()
        self._factory = factory

    def __getitem__(self, key):
        if key not in self:
            super().__setitem__(key, self._factory(key))
        return super().__getitem__(key)


class Iteration:
    def __init__(self, index: int, series: "Series"):
        self.index = index
        self._series = series
        self.time = 0.0
        self.dt = 1.0
        self.time_unit_SI = 1.0
        base = f"/data/{index}"
        self.meshes = _Container(
            lambda k: Mesh(f"{base}/meshes/{k}", series))
        self.particles = _Container(
            lambda k: ParticleSpecies(f"{base}/particles/{k}", series))
        self._closed = False

    def close(self):
        """Flush and seal — a closed iteration is never reopened."""
        self._series.flush()
        self._closed = True


class Series:
    """Root openPMD object. mode: 'w' (create) or 'r' (read).

    engine_config carries the ADIOS2-style knobs: aggregators
    (OPENPMD_ADIOS2_BP5_NumAgg), codec (blosc/bzip2), Lustre striping.
    """

    def __init__(self, path, mode: str = "w", *, n_ranks: int = 1,
                 engine_config: EngineConfig = EngineConfig(),
                 meta: Optional[dict] = None, async_io: bool = False,
                 queue_depth: int = 2, parallel_io: int = 0,
                 parallel_read: int = 0, async_commit: bool = False,
                 transport: str = "shm",
                 device_compress: Optional[bool] = None):
        self.path = pathlib.Path(str(path))
        self.mode = mode
        self.n_ranks = n_ranks
        if device_compress is not None:
            # convenience spelling of EngineConfig(device_compress=...): the
            # on-device bitshuffle stage for tensor chunks
            engine_config = dataclasses.replace(
                engine_config, device_compress=bool(device_compress))
        self.engine_config = engine_config
        # read-side mirror of parallel_io: load_chunk/read_var fan
        # multi-chunk reads over a ReaderPool of this many workers
        self.parallel_read = int(parallel_read)
        # engine-plane combinations are validated HERE, not at first flush:
        # a bad combination must fail at construction with the fix named
        if parallel_io and async_io:
            raise ValueError(
                "async_io=True names the single-process pipelined engine and "
                "does not stack on the parallel write plane; to overlap the "
                "producer with the W-process two-phase commit, spell it "
                f"Series(parallel_io={int(parallel_io)}, async_commit=True)")
        if async_commit and not parallel_io:
            raise ValueError(
                "async_commit=True is the parallel plane's pipelined commit "
                "and requires parallel_io=W; for the single-process engine "
                "use async_io=True instead")
        from repro_torch.core.shm_transport import validate_transport
        validate_transport(transport)
        self.async_io = async_io
        self.async_commit = bool(async_commit)
        self.transport = transport
        self.parallel_io = int(parallel_io)
        self.queue_depth = queue_depth
        self.iterations = _Container(lambda k: Iteration(k, self))
        # insertion-ordered, so a step's variables reach the engine
        # (and md.0 / data.*) in the order they were first stored
        self._dirty: dict[RecordComponent, None] = {}
        self._closed = False
        self._writer: Optional[BpWriter] = None
        self._reader_obj: Optional[BpReader] = None
        self._open_step: Optional[int] = None
        self.attributes = {
            "openPMD": OPENPMD_VERSION,
            "openPMDextension": 0,
            "basePath": BASE_PATH,
            "meshesPath": MESHES_PATH,
            "particlesPath": PARTICLES_PATH,
            "iterationEncoding": "groupBased",
            "iterationFormat": BASE_PATH,
            "software": "repro-jbp",
        }
        if meta:
            self.attributes.update(meta)
        if mode == "r":
            self._reader()

    # ----------------------------------------------------------------- write
    def _get_writer(self) -> BpWriter:
        if self._closed:
            # constructing a new writer on an already-written path would
            # reopen md.0/md.idx with "wb" and truncate sealed iterations
            raise RuntimeError(f"Series {self.path} is closed")
        if self._writer is None:
            if self.parallel_io:
                from repro_torch.core.parallel_engine import ParallelBpWriter
                self._writer = ParallelBpWriter(self.path, self.n_ranks,
                                                self.engine_config,
                                                n_writers=self.parallel_io,
                                                transport=self.transport,
                                                async_commit=self.async_commit,
                                                queue_depth=self.queue_depth)
            elif self.async_io:
                from repro_torch.core.async_engine import AsyncBpWriter
                self._writer = AsyncBpWriter(self.path, self.n_ranks,
                                             self.engine_config,
                                             queue_depth=self.queue_depth)
            else:
                self._writer = BpWriter(self.path, self.n_ranks,
                                        self.engine_config)
            for k, v in self.attributes.items():
                self._writer.set_attribute(k, v)
        return self._writer

    def flush(self):
        """Write all dirty record components as one engine step."""
        if not self._dirty:
            return None
        by_step: dict[int, list[RecordComponent]] = {}
        for rc in self._dirty:
            step = int(rc._path.split("/")[2])
            by_step.setdefault(step, []).append(rc)
        w = self._get_writer()
        prof = None
        for step in sorted(by_step):
            w.begin_step(step)
            it = self.iterations[step]
            w.set_attribute(f"/data/{step}/time", it.time)
            w.set_attribute(f"/data/{step}/dt", it.dt)
            for rc in by_step[step]:
                for arr, off, rank in rc._chunks:
                    w.put(rc._path, arr, global_shape=rc._global_extent,
                          offset=off, rank=rank, codec=rc.codec)
                rc._chunks.clear()
            prof = w.end_step()
        self._dirty.clear()
        return prof

    def drain(self):
        """Durability barrier: with async_io, block until every flushed
        iteration's md.idx record is sealed on disk. No-op for sync."""
        if self._writer is not None and hasattr(self._writer, "drain"):
            self._writer.drain()

    def close(self):
        """Flush remaining iterations and shut the engine down. The writer
        is ALWAYS closed (thread + md handles released) even when a flush
        or a queued async write failed — the error still propagates, and
        the series is dead afterwards: a later flush()/close() is a no-op
        (it must never construct a fresh writer on the same path, which
        would truncate the sealed iterations already on disk)."""
        if self._closed:
            return
        try:
            self.flush()
        finally:
            self._closed = True
            self._dirty.clear()
            if self._reader_obj is not None:
                # the reader caches one open handle per subfile now —
                # a closed Series must not keep M data.* fds alive
                r, self._reader_obj = self._reader_obj, None
                r.close()
            if self._writer is not None:
                w, self._writer = self._writer, None
                w.close()            # async: drains; cleanup-then-raise

    # ------------------------------------------------------------------ read
    def _reader(self) -> BpReader:
        if self._reader_obj is None:
            self._reader_obj = BpReader(self.path,
                                        parallel=self.parallel_read)
        return self._reader_obj

    def read_iterations(self) -> list[int]:
        return self._reader().valid_steps()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
