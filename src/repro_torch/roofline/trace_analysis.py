"""Per-device FLOPs, bytes and collective traffic counted on a trace of a
step: the counterpart of the JAX package's `repro/roofline/
hlo_analysis.py`, which parses compiled HLO text. PyTorch has no HLO to
parse, so `analyze` runs the step once under `TraceCounter`, a
`TorchDispatchMode` that sees every ATen op on each rank's local tensors
(DTensor ops are let through to DTensor, which desugars them into local
ops and collectives that come back to the counter, as `torch.distributed.
tensor.debug.CommDebugMode` counts them). Run it on fake tensors (the
dry-run's: `FakeTensorMode`, a fake process group) and nothing is
computed, only counted.

  * flops — products by `torch.utils.flop_counter`'s formulas (what
    `FlopCounterMode` counts: mm, bmm, convolutions, and the port's two
    kernels' custom ops, whose formulas count what the CUDA kernels
    compute), pointwise ops one a result element and reductions one an
    input element, as `hlo_analysis.ELEMENTWISE` and its reduce rule count
    them.
  * hbm bytes — each op's tensor inputs and outputs on the local shard (an
    in-place op's destination once; views, reshapes and metadata free),
    the kernels' custom ops included. Nothing is fused here, so this reads
    higher than XLA's bytes, which count a fusion's operands and output
    only: it is an upper bound of the traffic of the unfused PyTorch step.
    `analyze` gives the lower bound beside it: the bytes of the step's
    inputs and outputs, each once.
  * collectives — each functional collective by kind, with its bytes a
    device on the ring model of `hlo_analysis._collective_bytes` /
    `CollectiveRecord.traffic_bytes` (all-reduce 2 (g-1)/g of its output,
    all-gather (g-1)/g of its output, reduce-scatter (g-1) times its
    output, all-to-all its output), g the size of the group; and the
    part of it whose groups span more than one node of
    `analysis.NODE_GPUS` ranks (`collective_traffic_cross_node`).
  * the peak of the bytes that the trace's ops allocate and keep alive at
    once (the dry-run's temp bytes).

DTensor's own bookkeeping is not work and is not counted: ops on the
meta device, and the ops its sharding propagator runs on global-shape
fake tensors to learn an op's output shape (with a `FakeTensorMode`
active it reuses that mode, so they pass through the counter; the
counter pauses while `ShardingPropagator._propagate_tensor_meta_non_cached`
runs).

All numbers are PER DEVICE: rank 0's local work.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ATEN = torch.ops.aten

#: functional collectives -> the reference's kind names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "_dtensor")

_REDUCTIONS = {ATEN.sum, ATEN.mean, ATEN.amax, ATEN.amin, ATEN.max,
               ATEN.min, ATEN.logsumexp, ATEN._softmax, ATEN._log_softmax,
               ATEN.cumsum, ATEN.argmax, ATEN.argmin, ATEN.var_mean,
               ATEN.prod, ATEN.all, ATEN.any, ATEN.linalg_vector_norm}
#: copies move bytes and compute nothing (HLO's copy is no elementwise op)
_COPIES = {ATEN.clone, ATEN._to_copy, ATEN.copy_, ATEN.copy}
#: ops that return a tensor sharing its input's storage without being
#: schema views
_FREE = {ATEN._unsafe_view, ATEN.lift_fresh, ATEN.detach, ATEN.alias}


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    out_bytes: float
    group_size: int
    trips: float = 1.0
    #: the group spans more than one node of `analysis.NODE_GPUS` ranks
    cross_node: bool = False

    @property
    def traffic_bytes(self) -> float:
        """Ring-model per-device traffic (`hlo_analysis.CollectiveRecord`)."""
        g = max(self.group_size, 1)
        f = (g - 1) / g
        if self.kind == "all-reduce":
            return 2 * self.out_bytes * f * self.trips
        if self.kind == "all-gather":
            return self.out_bytes * f * self.trips
        if self.kind == "reduce-scatter":
            return self.out_bytes * g * f * self.trips
        return self.out_bytes * self.trips


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _group(args) -> tuple[int, bool]:
    """(size, spans nodes) of the process group a collective names."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    from repro_torch.roofline.analysis import NODE_GPUS
    for a in reversed(args):
        if isinstance(a, str):
            pg = _resolve_process_group(a)
            nodes = {r // NODE_GPUS
                     for r in dist.get_process_group_ranks(pg)}
            return pg.size(), len(nodes) > 1
    return 1, False


class TraceCounter(TorchDispatchMode):
    """Counts what each op does on this rank's tensors while it is
    active; read `flops`, `bytes`, `collectives`, `peak_bytes`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.product_flops = 0.0
        self.bytes = 0.0
        self.collectives: list[CollectiveRecord] = []
        self.ops = 0
        self.by_op: dict[str, list] = {}
        self._live: dict = {}
        self._cur = 0
        self.peak_bytes = 0
        self._paused = 0
        self._saved = None
        self._depth = 0

    def __enter__(self):
        # patched once, at the outermost entry: the mode re-enters itself
        # (`with self` around a decomposition)
        if self._depth == 0:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator as SP
            real = self._saved = SP._propagate_tensor_meta_non_cached

            def propagate(*a, **kw):
                self._paused += 1
                try:
                    return real(*a, **kw)
                finally:
                    self._paused -= 1
            SP._propagate_tensor_meta_non_cached = propagate
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator as SP
            SP._propagate_tensor_meta_non_cached = self._saved
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor desugars, then we count
        if (func._overloadpacket not in _flop_registry()
                and func.namespace == "aten"
                and torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd")):
            # a composite op (matmul, einsum: under inference_mode they
            # reach the mode whole) runs as the ops it is made of, which
            # come back here, as FlopCounterMode does it
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        ns = getattr(func, "namespace", "")
        name = packet.__name__
        if ns in _COLLECTIVE_NS and name in _COLLECTIVES:
            outs = _tensors(out)
            size, cross = _group(args)
            self.collectives.append(CollectiveRecord(
                _COLLECTIVES[name], float(sum(_nbytes(t) for t in outs)),
                size, cross_node=cross))
            return
        if ns == "_c10d_functional":     # wait_tensor and the like
            return
        outs = _tensors(out)
        if (func.is_view or packet in _FREE or not outs
                or outs[0].device.type == "meta"):
            # views, and DTensor's own shape bookkeeping on meta tensors
            return
        self.ops += 1
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            self.product_flops += flops
        elif torch.Tag.pointwise in func.tags and packet not in _COPIES:
            flops = float(_tensors(out)[0].numel())
        elif packet in _REDUCTIONS:
            ins = _tensors(args)
            flops = float(ins[0].numel()) if ins else 0.0
        written = set()
        schema = func._schema
        for a, t in zip(schema.arguments, args):
            if a.alias_info is not None and a.alias_info.is_write:
                written.add(id(t))
        nb = sum(_nbytes(t) for t in _tensors((args, kwargs))
                 if id(t) not in written)
        nb += sum(_nbytes(t) for t in _tensors(out))
        self.flops += flops
        self.bytes += nb
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nb
        if not schema.is_mutable:
            self._allocated(out)

    def _allocated(self, out):
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in _tensors(out):
            ref = StorageWeakRef(t.untyped_storage())
            if ref not in self._live:
                n = t.untyped_storage().nbytes()
                self._live[ref] = n
                self._cur += n
        if self.ops % 128 == 0:
            for ref in [r for r in self._live if r.expired()]:
                self._cur -= self._live.pop(ref)
        self.peak_bytes = max(self.peak_bytes, self._cur)


def summarize(counter: TraceCounter) -> dict:
    """The reference's `analyze` keys from a finished `TraceCounter`."""
    by_kind: dict[str, float] = {}
    n_ops: dict[str, float] = {}
    cross = 0.0
    for rec in counter.collectives:
        by_kind[rec.kind] = by_kind.get(rec.kind, 0.0) + rec.traffic_bytes
        n_ops[rec.kind] = n_ops.get(rec.kind, 0.0) + rec.trips
        cross += rec.traffic_bytes if rec.cross_node else 0.0
    return {
        "flops_per_device": counter.flops,
        "hbm_bytes_per_device": counter.bytes,
        "collective_traffic_per_device": sum(by_kind.values()),
        "collective_traffic_by_kind": by_kind,
        "collective_op_counts": n_ops,
        "collective_traffic_cross_node": cross,
        "product_flops_per_device": counter.product_flops,
        "peak_bytes_per_device": float(counter.peak_bytes),
        "ops": counter.ops,
    }


def io_bytes(*trees) -> float:
    """The bytes of the tensors in `trees` (a DTensor's local shard), a
    storage once, however many views of it appear: what a step that fused
    everything would still read or write once, so a lower bound of its
    traffic where `hbm_bytes_per_device` is the unfused upper bound."""
    from torch.multiprocessing.reductions import StorageWeakRef
    seen, n = set(), 0
    for t in _tensors(trees):
        t = getattr(t, "_local_tensor", t)
        ref = StorageWeakRef(t.untyped_storage())
        if ref not in seen:
            seen.add(ref)
            n += _nbytes(t)
    return float(n)


def analyze(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once under a `TraceCounter` and return
    the per-device counts, with the keys of the reference's `analyze`
    (`hlo_analysis.py`) and four more: the product FLOPs alone, the peak
    of the trace's own allocations, the number of ops counted and
    `io_bytes_per_device`, the bytes of the step's inputs and outputs
    (`io_bytes`; an output that is an input written in place counts
    once)."""
    with TraceCounter() as counter:
        out = fn(*args, **kwargs)
    return {**summarize(counter),
            "io_bytes_per_device": io_bytes(args, kwargs, out)}
