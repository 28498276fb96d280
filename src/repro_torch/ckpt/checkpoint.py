"""State checkpoint/restore through the JBP (openPMD/BP4) engine.

The checkpoint is one openPMD-style step whose variables are the flattened
state leaves ("electrons/.x", "key", ...), named exactly as the JAX
package's `flatten_state` names them, so a checkpoint written by either
package restores in the other. Leaves are written as row-split chunks by
logical I/O rank, so N ranks -> M aggregator subfiles exactly as the
paper's BIT1 checkpoints (.dmp) map onto BP4. A tensor leaf with
`device_compress` is split the same way, its chunks views of its rows,
and each chunk is byte-shuffled on its device before the host LZ stage.
`parallel_io=W` writes through W writer processes
(`repro_torch.core.parallel_engine`).

Model trees keep their layers in lists (`layers`, `units`, `first`,
`self_units`, `cross`: `models.convert.STACKED`), where the JAX package
stacks them into one array with leading axes [L] or [U, I]. Such a group
is checkpointed under the JAX package's names, as one variable of global
shape [L, ...] a leaf (`Stacked`): on the host path the layers are stacked
one leaf at a time and row-split as the JAX package splits them; with
`device_compress` each layer's tensor is the chunk at offset (l, 0, ...),
so nothing is stacked on the device. Either package's reader returns the
same global arrays, and a restore splits them back into the lists.

A DTensor leaf on a mesh of more than one device is saved collectively,
as the JAX package saves a sharded leaf: one chunk a rank's local shard,
at its box offset and at `rank=` its global rank (row-major over the
mesh, like a JAX device id), replicas included; every rank calls
`save_checkpoint` and every rank returns the same path. With
`parallel_io=W` the ranks are the write plane's writers: each writes its
own compressed chunks into its writer's subfile and rank 0 commits the
step from the chunk tables (`_save_by_rank`); otherwise rank 0 gathers
the shards' bytes and writes the series. With `device_compress` each rank
first byte-shuffles its shard on its device. A DTensor on a
one-device mesh is saved as its local tensor. `restore_sharded` is the
elastic restore: each rank reads only the box of each leaf that its
shard of the new layout needs, and builds DTensors.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import pickle
import shutil
import time
import traceback
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig
from repro_torch.core.dxt import TRACER
from repro_torch.models.convert import STACKED

SEP = "/"


@dataclasses.dataclass
class Stacked:
    """One leaf of a group of layers the JAX package stacks: `parts` are
    the layers' leaves in row-major order over the leading axes `lead`
    ([L] or [U, I]); the checkpoint variable is [*lead, *part.shape]."""
    lead: tuple
    parts: list

    @property
    def shape(self) -> tuple:
        return tuple(self.lead) + tuple(self.parts[0].shape)

    def offset(self, i: int) -> tuple:
        """The chunk offset of part i in the stacked variable."""
        idx = np.unravel_index(i, self.lead)
        return tuple(int(j) for j in idx) + (0,) * self.parts[0].ndim

    def map(self, fn) -> "Stacked":
        return Stacked(self.lead, [fn(p) for p in self.parts])


def _host_leaf(leaf) -> np.ndarray:
    """A leaf as a host array; bfloat16 tensors as their raw uint16 bits,
    the storage the JAX package uses for bfloat16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _tensor_from(arr: np.ndarray, dtype, shape, device) -> torch.Tensor:
    """A stored array as a tensor of `dtype` and `shape` on `device`
    (bfloat16 from its uint16 storage)."""
    if dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.astype(C.np_dtype(dtype), copy=False))
    with TRACER.span("h2d", length=t.numel() * t.element_size(),
                     layer="ckpt"):
        return t.reshape(shape).to(device)


def _restore_leaf(arr: np.ndarray, like):
    """A stored array in the form of `like`: a tensor on like's device
    (bfloat16 from its uint16 storage), an ndarray, or a Python scalar."""
    if isinstance(like, torch.Tensor):
        return _tensor_from(arr, like.dtype, like.shape, like.device)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype).reshape(like.shape)
    return type(like)(arr.reshape(-1)[0])


def _layers(obj, depth: int):
    """The layer subtrees of a nested list `depth` deep, row-major, and
    the list lengths."""
    if depth == 0:
        return [obj], ()
    subs = [_layers(o, depth - 1) for o in obj]
    lead = (len(obj),) + (subs[0][1] if subs else ())
    return [t for sub, _ in subs for t in sub], lead


def _is_stacked(k, v) -> bool:
    return k in STACKED and isinstance(v, list) and len(v) > 0


def _walk(prefix: tuple, obj):
    """(path, leaf) pairs in jax.tree_util's order: dict keys sorted,
    NamedTuple fields as ".name" (the str() of jax's GetAttrKey), list and
    tuple items by index, None an empty subtree. A group of layers under a
    `STACKED` key gives one `Stacked` a leaf, named as the JAX package
    names its stacked array."""
    if isinstance(obj, dict):
        for k in sorted(obj):
            if _is_stacked(k, obj[k]):
                layers, lead = _layers(obj[k], STACKED[k])
                per = [dict(_walk((), t)) for t in layers]
                for rel in per[0]:
                    yield (SEP.join(prefix + (str(k), rel)),
                           Stacked(lead, [f[rel] for f in per]))
            else:
                yield from _walk(prefix + (str(k),), obj[k])
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for f in obj._fields:
            yield from _walk(prefix + (f".{f}",), getattr(obj, f))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk(prefix + (str(i),), v)
    elif obj is not None:
        yield SEP.join(prefix), obj


def flatten_state(state) -> dict[str, Any]:
    return dict(_walk((), state))


def unflatten_like(like, flat: dict):
    """Rebuild `like`'s structure with the leaves of `flat` (by name; a
    group of layers from its `Stacked` leaves)."""
    def group(prefix: tuple, obj, depth: int, parts: dict, at: list):
        if depth == 0:
            i = at[0]
            at[0] += 1
            return build(prefix, obj, {k: v.parts[i] for k, v in
                                       parts.items()})
        return [group(prefix, o, depth - 1, parts, at) for o in obj]

    def build(prefix: tuple, obj, src=flat):
        if isinstance(obj, dict):
            out = {}
            for k in obj:
                if _is_stacked(k, obj[k]):
                    key = SEP.join(prefix + (str(k),)) + SEP
                    parts = {n[len(key):]: v for n, v in src.items()
                             if n.startswith(key)}
                    out[k] = group((), obj[k], STACKED[k], parts, [0])
                else:
                    out[k] = build(prefix + (str(k),), obj[k], src)
            return out
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*(build(prefix + (f".{f}",), getattr(obj, f),
                                     src) for f in obj._fields))
        if isinstance(obj, (list, tuple)):
            return type(obj)(build(prefix + (str(i),), v, src)
                             for i, v in enumerate(obj))
        if obj is None:
            return None
        return src[SEP.join(prefix)]
    return build((), like)


def _leaf_chunks(arr, n_ranks: int):
    """(rank, offset, chunk) row-split of a host array or a tensor
    (scalars -> [1]); a tensor's chunks are views of its rows."""
    if arr.ndim == 0:
        yield 0, (0,), arr.reshape(1)
        return
    n = min(n_ranks, arr.shape[0]) or 1
    bounds = np.linspace(0, arr.shape[0], n + 1).astype(int)
    for r in range(n):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        if hi > lo:
            yield r, (lo,) + (0,) * (arr.ndim - 1), arr[lo:hi]


def save_checkpoint(directory, state, step: int, *, n_io_ranks: int = 8,
                    engine_config: EngineConfig = EngineConfig(),
                    extra_attrs: Optional[dict] = None,
                    async_io: bool = False,
                    parallel_io: int = 0,
                    writer_plane=None,
                    transport: str = "shm",
                    device_compress: bool = False) -> pathlib.Path:
    """Atomic checkpoint write: <dir>/step_<N>.bp4 (.tmp + rename).

    With `async_io` the write goes through the AsyncBpWriter pipeline;
    fsync_policy is still forced to "step", which the async engine honours
    with a BLOCKING seal — so by the time the .tmp is renamed the step's
    md.idx record is durable either way. `parallel_io=W` instead writes
    through W real writer processes (two-phase commit; the md.idx seal and
    every subfile/shard fsync precede the rename), with chunk bytes moved
    over per-worker shared-memory rings (`transport="shm"`, the default)
    rather than pickled down queues. `writer_plane` (a
    `repro_torch.core.parallel_engine.WriterPlane`) supplies
    ALREADY-RUNNING writer processes for the parallel path — the spawn
    cost is the plane owner's, paid once per run instead of once per save,
    and the plane's rings stay mapped across saves (the plane inherits its
    own transport; `transport` applies to the spawn-per-save path).

    `device_compress=True` (with the blosc codec) hands every tensor leaf
    of rank >= 1 to the engine as tensors, row-split by rank as a host
    leaf is, so its chunks spread over the aggregators (or writers) and
    are encoded in parallel. Each chunk is byte-shuffled on its device
    (the bitshuffle kernel for a CUDA tensor), one launch a chunk for all
    its 1 MiB codec blocks, and only the LZ stage runs on the host. 0-d
    leaves, Python scalars and bfloat16 (raw uint16 storage) keep the host
    path. With `parallel_io` the coordinator shuffles such a chunk and the
    workers receive pre-shuffled host bytes: they pay only the LZ stage.

    DTensor leaves on a mesh of more than one device make the save
    collective: every rank calls it. With `parallel_io=W` (or a
    `writer_plane`, whose size gives W) each rank is the writer of its own
    chunks (`_save_by_rank`: no shard bytes go to rank 0, and the plane's
    processes are not used); otherwise each rank's chunks go through rank
    0, which alone opens the writer (`_save_sharded`).

    `SAVE_STATS` holds this process's numbers of its last sharded save."""
    directory = pathlib.Path(str(directory))
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}.bp4"
    tmp = directory / f"step_{step:08d}.bp4.tmp"
    flat = flatten_state(state)
    cfg = dataclasses.replace(engine_config, fsync_policy="step",
                              device_compress=(device_compress
                                               or engine_config.device_compress))
    use_dev = cfg.device_compress and C.codec_wants_device(cfg.codec)
    if any(_sharded(v) for v in flat.values()):
        if parallel_io or writer_plane is not None:
            n_writers = parallel_io or writer_plane.m
            return _save_by_rank(directory, final, tmp, flat, step, cfg,
                                 use_dev, n_io_ranks, extra_attrs, n_writers)
        return _save_sharded(directory, final, tmp, flat, step, cfg, use_dev,
                             n_io_ranks, extra_attrs, async_io, parallel_io,
                             writer_plane, transport)
    flat = {k: _on_one_device(v) for k, v in flat.items()}
    if tmp.exists():
        shutil.rmtree(tmp)
    w = _open_writer(tmp, cfg, n_io_ranks, async_io, parallel_io,
                     writer_plane, transport)
    try:
        _begin(w, step, len(flat), extra_attrs)
        for name, leaf in flat.items():
            for gshape, off, rank, chunk in _chunks(leaf, use_dev,
                                                    n_io_ranks):
                w.put(f"state/{name}", chunk, global_shape=gshape,
                      offset=off, rank=rank)
        w.end_step()
    except BaseException:
        _close_quietly(w)
        raise
    w.close()
    _publish(directory, final, tmp, step)
    return final


def _open_writer(tmp, cfg, n_io_ranks, async_io, parallel_io, writer_plane,
                 transport):
    if parallel_io or writer_plane is not None:
        from repro_torch.core.parallel_engine import ParallelBpWriter
        return ParallelBpWriter(tmp, n_io_ranks, cfg,
                                n_writers=parallel_io or None,
                                plane=writer_plane, transport=transport)
    if async_io:
        from repro_torch.core.async_engine import AsyncBpWriter
        return AsyncBpWriter(tmp, n_io_ranks, cfg)
    return BpWriter(tmp, n_io_ranks, cfg)


def _begin(w, step: int, n_leaves: int, extra_attrs):
    w.begin_step(step)
    w.set_attribute("checkpoint/step", step)
    w.set_attribute("checkpoint/n_leaves", n_leaves)
    for k, v in (extra_attrs or {}).items():
        w.set_attribute(k, v)


def _close_quietly(w):
    """A failed save must not leak the writer thread / open md handles;
    the ORIGINAL error is what propagates."""
    try:
        w.close()
    except BaseException:        # noqa: BLE001
        pass


def _publish(directory, final, tmp, step: int):
    with TRACER.span("publish", path=str(final), layer="ckpt"):
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        (directory / "latest.txt").write_text(str(step))


def _device_leaf(leaf, use_dev: bool) -> bool:
    """Whether `leaf` stays a tensor for the engine's device shuffle."""
    return (use_dev and C.is_device_array(leaf) and leaf.ndim > 0
            and leaf.dtype != torch.bfloat16)


def _chunks(leaf, use_dev: bool, n_ranks: int):
    """(global_shape, offset, rank, chunk) of a leaf off any mesh, row-split
    by rank. A device leaf stays a tensor, its chunks views of its rows:
    the engine preconditions each chunk on its device."""
    if isinstance(leaf, Stacked):
        yield from _stacked_chunks(leaf, use_dev, n_ranks)
        return
    if not _device_leaf(leaf, use_dev):
        leaf = _host_leaf(leaf)
    gshape = tuple(leaf.shape) if leaf.ndim else (1,)
    for r, off, chunk in _leaf_chunks(leaf, n_ranks):
        yield gshape, off, r, chunk


def _stacked_chunks(leaf: Stacked, use_dev: bool, n_ranks: int):
    """A group of layers as the JAX package's stacked variable. Device
    leaves: layer i is the chunk at (i, 0, ...) (row-major over `lead`),
    put by rank i mod `n_ranks` so the layers spread over the aggregators.
    Host leaves: stacked on the host and row-split like any host leaf, so
    the chunk table is the JAX package's."""
    gshape = leaf.shape
    if all(_device_leaf(p, use_dev) for p in leaf.parts):
        ones = (1,) * len(leaf.lead)
        for i, part in enumerate(leaf.parts):
            yield (gshape, leaf.offset(i), i % n_ranks,
                   part.reshape(ones + tuple(part.shape)))
        return
    host = np.stack([_host_leaf(p) for p in leaf.parts]).reshape(gshape)
    for r, off, chunk in _leaf_chunks(host, n_ranks):
        yield gshape, off, r, chunk


# --------------------------------------------------------- DTensor leaves
def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded(leaf) -> bool:
    """A DTensor leaf (or layer group of them) on a mesh of more than one
    device."""
    if isinstance(leaf, Stacked):
        return any(_sharded(p) for p in leaf.parts)
    return _dtensor(leaf) and leaf.device_mesh.size() > 1


def _on_one_device(leaf):
    """A DTensor on a one-device mesh as its local tensor (the same
    storage); any other leaf as it is."""
    if isinstance(leaf, Stacked):
        return leaf.map(_on_one_device)
    return leaf.to_local() if _dtensor(leaf) else leaf


def _local_box(x) -> tuple:
    """The global offset of this rank's shard of DTensor `x`: a dim split
    over several mesh dims is split row-major in mesh-dim order, as
    DTensor and `launch.sharding.shard_box` split it."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    shape = tuple(x.shape)
    idx, n = [0] * len(shape), [1] * len(shape)
    for i, p in enumerate(x.placements):
        if type(p) is Shard:
            idx[p.dim] = idx[p.dim] * mesh.size(i) + coord[i]
            n[p.dim] *= mesh.size(i)
        elif not p.is_replicate():
            raise ValueError(f"cannot checkpoint a DTensor with placement "
                             f"{p!r}: only Shard and Replicate")
    if any(s % k for s, k in zip(shape, n)):
        raise ValueError(f"DTensor of shape {shape} splits unevenly over "
                         f"{x.placements}")
    return tuple(i * (s // k) for i, s, k in zip(idx, shape, n))


def _shard_chunk(local: torch.Tensor, use_dev: bool, shape):
    """One rank's shard reshaped to `shape`: a tensor for the device
    shuffle of `C.outbound_chunk`, or on the host."""
    local = local.reshape(shape)
    return local if _device_leaf(local, use_dev) else _host_leaf(local)


def _rank_chunks(leaf, use_dev: bool, rank: int) -> list:
    """(global_shape, offset, rank, chunk) of this rank's shards of a
    sharded leaf. A 0-d leaf is written as its 0-d self at offset (), as
    the JAX package writes a replicated scalar; a group of layers is the
    stacked variable: the shards of all layers stacked on the host into
    one chunk [*lead, *box] (the JAX package's chunk), or with
    `device_compress` one chunk a layer at (i, *box)."""
    if not isinstance(leaf, Stacked):
        local = leaf.to_local()
        if leaf.ndim == 0:
            return [((), (), rank, _host_leaf(local).reshape(()))]
        return [(tuple(leaf.shape), _local_box(leaf), rank,
                 _shard_chunk(local, use_dev, local.shape))]
    gshape = leaf.shape
    zeros = (0,) * len(leaf.lead)
    box = _local_box(leaf.parts[0])
    if all(_device_leaf(p.to_local(), use_dev) for p in leaf.parts):
        ones = (1,) * len(leaf.lead)
        return [(gshape, leaf.offset(i)[:len(leaf.lead)] + _local_box(p),
                 rank, _shard_chunk(p.to_local(), use_dev,
                                    ones + tuple(p.to_local().shape)))
                for i, p in enumerate(leaf.parts)]
    local = [_host_leaf(p.to_local()) for p in leaf.parts]
    stacked = np.stack(local).reshape(tuple(leaf.lead) + local[0].shape)
    return [(gshape, zeros + box, rank, stacked)]


def _save_sharded(directory, final, tmp, flat, step, cfg, use_dev,
                  n_io_ranks, extra_attrs, async_io, parallel_io,
                  writer_plane, transport) -> pathlib.Path:
    """The collective save of a state with sharded DTensor leaves: every
    rank makes the chunks of its own shards (byte-shuffled on its device
    with `device_compress`), rank 0 gathers them leaf by leaf, in rank
    order, and writes the series. Leaves off any mesh are rank 0's to
    write, row-split by I/O rank as a single-device save writes them."""
    import torch.distributed as dist
    from repro_torch.core.darshan import CTR, MONITOR
    rank, world = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    received = 0
    w = None
    if rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        w = _open_writer(tmp, cfg, n_io_ranks, async_io, parallel_io,
                         writer_plane, transport)
    try:
        if w is not None:
            _begin(w, step, len(flat), extra_attrs)
        for name, leaf in flat.items():
            if _sharded(leaf):
                # shuffled here, booked below by rank 0 (its monitor
                # writes the series)
                mine = [(g, o, r, C.outbound_chunk(c, cfg, None))
                        for g, o, r, c in _rank_chunks(leaf, use_dev, rank)]
            elif rank == 0:
                mine = list(_chunks(_on_one_device(leaf), use_dev,
                                    n_io_ranks))
            else:
                mine = []
            # rank 0 keeps its own chunks (tensors stay where they are)
            got = [None] * world if rank == 0 else None
            dist.gather_object([] if rank == 0 else mine, got, dst=0)
            if w is None:
                continue
            received += sum(c[3].nbytes for g in got[1:] for c in g)
            got[0] = mine
            for chunks in got:
                for gshape, off, r, chunk in chunks:
                    if isinstance(chunk, C.PreshuffledChunk):
                        MONITOR.record(0, str(tmp),
                                       CTR.COMPRESS_DEVICE_BYTES,
                                       inc=float(chunk.device_bytes))
                    w.put(f"state/{name}", chunk, global_shape=gshape,
                          offset=off, rank=r)
        if w is not None:
            w.end_step()
    except BaseException:
        if w is not None:
            _close_quietly(w)
        raise
    if w is not None:
        w.close()
        _publish(directory, final, tmp, step)
    dist.barrier()
    SAVE_STATS.clear()
    SAVE_STATS.update(path="gather", rank=rank, bytes_to_rank0=received,
                      seconds=time.perf_counter() - t0)
    return final


#: this process's numbers of its last sharded save: "path" ("gather" or
#: "by_rank"), "rank", "bytes_to_rank0" (at rank 0: through rank 0, the
#: chunk bytes the other ranks sent it; one writer a rank, the pickled
#: sizes and chunk tables), "seconds"; by rank also "bytes_written" (this
#: rank's payload bytes), "writer" and the phases' seconds
SAVE_STATS: dict = {}


def _save_by_rank(directory, final, tmp, flat, step, cfg, use_dev,
                  n_io_ranks, extra_attrs, n_writers) -> pathlib.Path:
    """The collective save of sharded leaves with one writer a rank, the
    write plane's protocol with the ranks as its writers. Writer w of
    M = min(W, world) owns the ranks `writer_rank_range(w, world, M)` and
    the subfile `data.<w>`; rank r is the chunk rank r, as a JAX device id
    is (so `n_io_ranks` must be the world size).

    1. Each rank makes and compresses its own chunks (its shards, byte-
       shuffled on its device with `device_compress`; of a leaf off any
       mesh, the same on every rank, the row chunks of its own rank).
    2. The ranks exchange the sizes of their chunks, nothing else, and
       each works out where its chunks go in its writer's subfile: the
       order of the plane's writer process, variable by variable in the
       state's order and rank by rank within one (an exclusive scan).
    3. Each rank writes its payloads there and fsyncs; the first rank of
       each writer seals the writer's shard record `md.<w>.shard` (the
       prepared vote) from the chunk tables of its ranks.
    4. Rank 0 reads every shard record back, crc-checked, and commits the
       step: `md.0` and the crc-sealed `md.idx` record, then publishes.
    A failure anywhere before the commit leaves no `md.idx` record and no
    published step, as a torn step of the plane. Every phase ends in an
    exchange that carries each rank's error, so the ranks raise
    together. The files are the JAX package's
    `save_checkpoint(parallel_io=W, n_io_ranks=world)` of the same
    sharded state, byte for byte (`md.idx` aside from its time field),
    except for a tensor leaf off any mesh saved with `device_compress`:
    here it is row-split by rank, each rank shuffling and encoding its own
    rows, where the JAX package writes it whole at rank 0."""
    import torch.distributed as dist
    from repro_torch.core.aggregation import aggregator_of
    from repro_torch.core.bp_engine import (ChunkMeta, build_md_record,
                                            encode_chunk,
                                            record_compress_counters,
                                            seal_md_record)
    from repro_torch.core.darshan import open_file
    from repro_torch.core.parallel_engine import (read_shard_record,
                                                  seal_shard_record,
                                                  shard_path)
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_io_ranks != world:
        raise ValueError(f"a sharded save with one writer a rank writes "
                         f"chunk rank r from rank r: n_io_ranks must be the "
                         f"world size {world}, got {n_io_ranks}")
    if cfg.stripe is not None:
        raise ValueError("a sharded save with one writer a rank writes "
                         "plain subfiles (no striping)")
    m = min(max(1, int(n_writers)), world)
    mine_w = aggregator_of(rank, world, m)
    group = [r for r in range(world) if aggregator_of(r, world, m) == mine_w]
    t0 = time.perf_counter()
    names = list(flat)
    received = 0

    def exchange(ok_val, err):
        """all ranks' (value, error); raise if any rank failed."""
        got = [None] * world
        dist.all_gather_object(got, (ok_val, err))
        bad = [(r, e) for r, (_, e) in enumerate(got) if e is not None]
        if bad:
            raise RuntimeError("sharded save failed on rank(s) "
                               + ", ".join(f"{r}:\n{e}" for r, e in bad))
        return [v for v, _ in got]

    # ---- rank 0 lays out the series; 1. each rank encodes its chunks
    items, err = [], None
    try:
        if rank == 0:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for w in range(m):
                open_file(tmp / f"data.{w}", "wb", rank=w).close()
                open_file(shard_path(tmp, w), "wb", rank=w).close()
        for i, name in enumerate(names):
            leaf = flat[name]
            if _sharded(leaf):
                chunks = _rank_chunks(leaf, use_dev, rank)
            else:
                chunks = [c for c in _chunks(_on_one_device(leaf), use_dev,
                                             n_io_ranks) if c[2] == rank]
            for gshape, off, r, chunk in chunks:
                chunk = C.outbound_chunk(chunk, cfg, tmp)
                raw = chunk.nbytes
                payload, shape, stats, _ = encode_chunk(
                    chunk, cfg.codec, cfg.compression_block)
                record_compress_counters(rank, f"data.{mine_w}", cfg.codec,
                                         raw, len(payload), None)
                items.append((i, r, tuple(off), tuple(shape), payload,
                              stats, C.np_dtype(chunk.dtype).str,
                              tuple(gshape)))
    except Exception:                             # noqa: BLE001 — shared
        err = traceback.format_exc()
    t_encode = time.perf_counter() - t0

    # ---- 2. sizes only: the offsets of each rank's chunks in its subfile
    sizes = exchange([(it[0], len(it[4])) for it in items], err)
    base, pos = 0, {}
    for i in range(len(names)):
        for r in group:
            for j, (vi, nb) in enumerate(sizes[r]):
                if vi == i:
                    pos[(r, j)] = base
                    base += nb
    # ---- 3. write this rank's payloads; the writer's first rank seals
    t1 = time.perf_counter()
    metas, err = [], None
    try:
        path = tmp / f"data.{mine_w}"
        with open_file(path, "r+b", rank=rank) as f:
            for j, it in enumerate(items):
                f.seek(pos[(rank, j)])
                f.write(it[4])
            f.fsync()
        metas = [(i, ChunkMeta(r, off, shape, mine_w, pos[(rank, j)],
                               len(payload), *stats).to_json(), dt, gs)
                 for j, (i, r, off, shape, payload, stats, dt, gs)
                 in enumerate(items)]
    except Exception:                             # noqa: BLE001 — shared
        err = traceback.format_exc()
    tables = exchange(metas, err)
    written = sum(len(it[4]) for it in items)
    t_write = time.perf_counter() - t1
    sealed, err = None, None
    try:
        if rank == group[0]:
            order = sorted((i, r, j, meta) for r in group
                           for j, (i, meta, _, _) in enumerate(tables[r]))
            chunks: dict[str, list] = {}
            for i, _r, _j, meta in order:
                chunks.setdefault(f"state/{names[i]}", []).append(meta)
            with open_file(shard_path(tmp, mine_w), "r+b",
                           rank=mine_w) as shard:
                shard.seek(0, 2)
                sealed = seal_shard_record(shard, step, chunks)
                shard.fsync()
    except Exception:                             # noqa: BLE001 — shared
        err = traceback.format_exc()
    votes = exchange(sealed, err)
    # ---- 4. rank 0 validates the votes and commits
    t2 = time.perf_counter()
    err = None
    try:
        if rank == 0:
            received = sum(len(pickle.dumps(t)) for t in tables[1:])
            received += sum(len(pickle.dumps(s)) for s in sizes[1:])
            merged: dict[str, list] = {f"state/{n}": [] for n in names}
            for w in range(m):
                first = next(r for r in range(world)
                             if aggregator_of(r, world, m) == w)
                if votes[first] is None:
                    continue
                rec = read_shard_record(tmp, w, votes[first], step)
                for name, lst in rec["chunks"].items():
                    merged[name].extend(lst)
            pending = {}
            for r in range(world):
                for i, _meta, dt, gs in tables[r]:
                    pending.setdefault(f"state/{names[i]}",
                                       {"dtype": dt, "shape": gs})
            pending = {f"state/{n}": pending[f"state/{n}"] for n in names}
            attrs = {"checkpoint/step": step,
                     "checkpoint/n_leaves": len(flat), **(extra_attrs or {})}
            blob = json.dumps(build_md_record(step, attrs, pending,
                                              merged)).encode()
            with open_file(tmp / "md.0", "wb", rank=0) as md, \
                    open_file(tmp / "md.idx", "wb", rank=0) as idx:
                seal_md_record(md, idx, 0, step, blob, fsync_step=True)
            if cfg.profiling:
                doc = {"engine": "JBP(BP4-parallel)", "aggregators": m,
                       "writers": m, "codec": cfg.codec,
                       "transport": "rank",
                       "steps": [{"step": step, "encode_s": t_encode,
                                  "write_s": t_write,
                                  "commit_s": time.perf_counter() - t2}]}
                with open_file(tmp / "profiling.json", "w", rank=0) as f:
                    f.write(json.dumps(doc, indent=1))
            _publish(directory, final, tmp, step)
    except Exception:                             # noqa: BLE001 — shared
        err = traceback.format_exc()
    exchange(None, err)
    SAVE_STATS.clear()
    SAVE_STATS.update(path="by_rank", rank=rank, writer=mine_w,
                      bytes_written=written, bytes_to_rank0=received,
                      encode_s=t_encode, write_s=t_write,
                      seconds=time.perf_counter() - t0)
    return final


def list_checkpoints(directory) -> list[int]:
    directory = pathlib.Path(str(directory))
    out = []
    for p in sorted(directory.glob("step_*.bp4")):
        try:
            with BpReader(p) as reader:
                if reader.valid_steps():
                    out.append(int(p.name[5:13]))
        except Exception:       # noqa: BLE001 — corrupt checkpoint: skip
            continue
    return sorted(out)


def checkpoint_path(directory, step: int) -> pathlib.Path:
    return pathlib.Path(str(directory)) / f"step_{step:08d}.bp4"


def restore_checkpoint(directory, like, step: Optional[int] = None,
                       *, parallel: int = 0):
    """Restore into the structure of `like`: each tensor leaf comes back as
    a tensor of like's dtype on like's device, each Python scalar as one of
    its type. Full-array read (single-host path). `parallel=N` fans
    multi-chunk leaf reads over a ReaderPool. Returns (state, step)."""
    directory = pathlib.Path(str(directory))
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(f"no valid checkpoints under {directory}")
    step = step if step is not None else steps[-1]
    out = {}
    with BpReader(checkpoint_path(directory, step),
                  parallel=parallel) as reader:
        for name, leaf in flatten_state(like).items():
            arr = reader.read_var(step, f"state/{name}")
            if isinstance(leaf, Stacked):
                rows = arr.reshape((-1,) + tuple(leaf.parts[0].shape))
                out[name] = Stacked(leaf.lead, [
                    _restore_leaf(rows[i], p)
                    for i, p in enumerate(leaf.parts)])
            else:
                out[name] = _restore_leaf(arr, leaf)
    return unflatten_like(like, out), step


def restore_sharded(directory, like, shardings, step: Optional[int] = None,
                    *, parallel: int = 0):
    """Elastic restore: `like` (tensors or meta tensors, of which only the
    shape and dtype are read) and `shardings` (a tree of
    `launch.sharding.NamedSharding` on a `DeviceMesh`, in like's
    structure, e.g. `train.state.train_state_shardings`) describe the NEW
    layout. Each rank reads exactly the box of each leaf its shard needs
    from the chunk table and returns DTensors on the mesh's device; 0-d
    leaves are read whole and replicated, and a group of layers is read a
    layer at a time, the box (i, *box) of the stacked variable. Every
    rank calls it. Returns (state, step)."""
    directory = pathlib.Path(str(directory))
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(f"no valid checkpoints under {directory}")
    step = step if step is not None else steps[-1]
    flat_sh = flatten_state(shardings)
    out = {}
    with BpReader(checkpoint_path(directory, step),
                  parallel=parallel) as reader:
        for name, leaf in flatten_state(like).items():
            var, sh = f"state/{name}", flat_sh[name]
            if isinstance(leaf, Stacked):
                out[name] = Stacked(leaf.lead, [
                    _read_shard(reader, step, var, p, s,
                                leaf.offset(i)[:len(leaf.lead)])
                    for i, (p, s) in enumerate(zip(leaf.parts, sh.parts))])
            else:
                out[name] = _read_shard(reader, step, var, leaf, sh, ())
    return unflatten_like(like, out), step


def _read_shard(reader, step: int, var: str, like, sharding, lead: tuple):
    """This rank's DTensor of one leaf (or of layer `lead` of a stacked
    variable) laid out as `sharding`."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.sharding import shard_box
    if not isinstance(like, torch.Tensor):
        return _restore_leaf(reader.read_var(step, var), like)
    mesh = sharding.mesh
    shape = tuple(like.shape)
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    ones = (1,) * len(lead)
    if not shape and not lead:
        arr = reader.read_var(step, var)          # stored as [1] or ()
        placements = [Replicate() for _ in range(mesh.ndim)]
    else:
        off, ext = shard_box(sharding.spec, mesh, shape,
                             mesh.get_coordinate())
        arr = reader.read_var(step, var, lead + off, ones + ext)
        placements = sharding.placements
    local = _tensor_from(arr, like.dtype, arr.shape[len(lead):] if shape
                         else (), dev)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)
