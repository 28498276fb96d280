"""State checkpoint/restore through the JBP (openPMD/BP4) engine.

The checkpoint is one openPMD-style step whose variables are the flattened
state leaves ("electrons/.x", "key", ...), named exactly as the JAX
package's `flatten_state` names them, so a checkpoint written by either
package restores in the other. Host leaves are written as row-split chunks
by logical I/O rank, so N ranks -> M aggregator subfiles exactly as the
paper's BIT1 checkpoints (.dmp) map onto BP4. A tensor leaf with
`device_compress` is handed to the engine whole, at rank 0, and
byte-shuffled on its device before the host LZ stage. `parallel_io=W`
writes through W writer processes (`repro_torch.core.parallel_engine`).

Model trees keep their layers in lists (`layers`, `units`, `first`,
`self_units`, `cross`: `models.convert.STACKED`), where the JAX package
stacks them into one array with leading axes [L] or [U, I]. Such a group
is checkpointed under the JAX package's names, as one variable of global
shape [L, ...] a leaf (`Stacked`): on the host path the layers are stacked
one leaf at a time and row-split as the JAX package splits them; with
`device_compress` each layer's tensor is the chunk at offset (l, 0, ...),
so nothing is stacked on the device. Either package's reader returns the
same global arrays, and a restore splits them back into the lists.

A leaf sharded over a device mesh, and the elastic re-sharding restore
(`restore_sharded`), come with the port's mesh layer (DTensor).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig
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


def _restore_leaf(arr: np.ndarray, like):
    """A stored array in the form of `like`: a tensor on like's device
    (bfloat16 from its uint16 storage), an ndarray, or a Python scalar."""
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.astype(C.np_dtype(like.dtype), copy=False))
        return t.reshape(like.shape).to(like.device)
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


def _leaf_chunks(arr: np.ndarray, n_ranks: int):
    """(rank, offset, chunk) row-split of a host array (scalars -> [1])."""
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
    of rank >= 1 to the engine as it is: it is byte-shuffled on its device
    (the bitshuffle kernel for a CUDA tensor), one launch a leaf for all
    its 1 MiB codec blocks, and only the LZ stage runs on the host. 0-d
    leaves, Python scalars and bfloat16 (raw uint16 storage) keep the host
    path. With `parallel_io` the coordinator shuffles such a leaf and the
    workers receive pre-shuffled host bytes: they pay only the LZ stage.
    Such a leaf is one chunk at rank 0, so it lands on writer 0."""
    directory = pathlib.Path(str(directory))
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}.bp4"
    tmp = directory / f"step_{step:08d}.bp4.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)

    flat = flatten_state(state)
    cfg = dataclasses.replace(engine_config, fsync_policy="step",
                              device_compress=(device_compress
                                               or engine_config.device_compress))
    use_dev = cfg.device_compress and C.codec_wants_device(cfg.codec)
    if parallel_io or writer_plane is not None:
        from repro_torch.core.parallel_engine import ParallelBpWriter
        w = ParallelBpWriter(tmp, n_io_ranks, cfg,
                             n_writers=parallel_io or None,
                             plane=writer_plane, transport=transport)
    elif async_io:
        from repro_torch.core.async_engine import AsyncBpWriter
        w = AsyncBpWriter(tmp, n_io_ranks, cfg)
    else:
        w = BpWriter(tmp, n_io_ranks, cfg)
    try:
        w.begin_step(step)
        w.set_attribute("checkpoint/step", step)
        w.set_attribute("checkpoint/n_leaves", len(flat))
        for k, v in (extra_attrs or {}).items():
            w.set_attribute(k, v)
        for name, leaf in flat.items():
            if isinstance(leaf, Stacked):
                _put_stacked(w, f"state/{name}", leaf, use_dev, n_io_ranks)
                continue
            if _device_leaf(leaf, use_dev):
                # stays a tensor: the engine preconditions it on its device
                w.put(f"state/{name}", leaf, global_shape=tuple(leaf.shape),
                      offset=(0,) * leaf.ndim, rank=0)
                continue
            host = _host_leaf(leaf)
            gshape = host.shape if host.ndim else (1,)
            for r, off, chunk in _leaf_chunks(host, n_io_ranks):
                w.put(f"state/{name}", chunk, global_shape=gshape,
                      offset=off, rank=r)
        w.end_step()
    except BaseException:
        # a failed save must not leak the writer thread / open md handles;
        # the ORIGINAL error is what propagates
        try:
            w.close()
        except BaseException:        # noqa: BLE001
            pass
        raise
    w.close()
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    (directory / "latest.txt").write_text(str(step))
    return final


def _device_leaf(leaf, use_dev: bool) -> bool:
    """Whether `leaf` stays a tensor for the engine's device shuffle."""
    return (use_dev and C.is_device_array(leaf) and leaf.ndim > 0
            and leaf.dtype != torch.bfloat16)


def _put_stacked(w, var: str, leaf: Stacked, use_dev: bool, n_ranks: int):
    """A group of layers as the JAX package's stacked variable. Device
    leaves: layer i is the chunk at (i, 0, ...) (row-major over `lead`),
    put by rank i mod `n_ranks` so the layers spread over the aggregators.
    Host leaves: stacked on the host and row-split like any host leaf, so
    the chunk table is the JAX package's."""
    gshape = leaf.shape
    if all(_device_leaf(p, use_dev) for p in leaf.parts):
        ones = (1,) * len(leaf.lead)
        for i, part in enumerate(leaf.parts):
            w.put(var, part.reshape(ones + tuple(part.shape)),
                  global_shape=gshape, offset=leaf.offset(i),
                  rank=i % n_ranks)
        return
    host = np.stack([_host_leaf(p) for p in leaf.parts]).reshape(gshape)
    for r, off, chunk in _leaf_chunks(host, n_ranks):
        w.put(var, chunk, global_shape=gshape, offset=off, rank=r)


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
