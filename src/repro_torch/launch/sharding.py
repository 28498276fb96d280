"""Partition rules: param/opt/cache trees -> specs and shardings. The port
of the JAX package's `launch/sharding.py`, rule for rule.

Policy (DESIGN.md §4):
  * `model` (tp): attention heads OR head_dim (per-arch, see attn_layout),
    d_ff, vocab, experts, SSM heads.
  * `data` (fsdp): the complementary weight dim (ZeRO-3-style); batch.
  * `pod`: pure data parallel — batch only, params replicated across pods.

Every rule is divisibility-guarded: a dim that doesn't divide the axis size
falls back to replicated on that axis (e.g. smollm's 15 heads).

A spec (`P`) names, for each tensor dim, None, a mesh axis or a tuple of
axes (major to minor, as JAX splits a dim); `to_placements` turns it into
DTensor's placements, one a mesh dim. The rules read only the mesh's axis
names and sizes, so they run on a `launch.mesh.AbstractMesh` as well as on
a `DeviceMesh`.

The port's model trees keep a group of layers in lists
(`models.convert.STACKED`) where the JAX package stacks them. A layer's
rule is looked up under the JAX package's stacked path (the list index
dropped) and evaluated on the stacked shape (`lead + layer shape`); the
layer then takes the spec without its leading entries, which are None:
stacked axes are never sharded.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.models.convert import STACKED

FSDP = "data"
TP = "model"
BATCH = ("pod", "data")


def _entry(e):
    """One spec entry as JAX's PartitionSpec keeps it: a list is a tuple,
    an empty tuple None, a tuple of one name that name."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P:
    """A partition spec: one entry a tensor dim (None, an axis name, or a
    tuple of names); trailing dims past the entries are replicated."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}" if len(self) != 1 else \
            f"P({self.entries[0]!r})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a `DeviceMesh`, or an `AbstractMesh` for the
    rules alone)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or an `AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def to_placements(spec, mesh) -> list:
    """DTensor placements, one a mesh dim, for a per-tensor-dim `spec`: a
    mesh dim named in entry d is `Shard(d)`, any other `Replicate()`. A
    tuple entry shards its dim over several mesh dims, major to minor;
    DTensor splits in mesh-dim order, so the tuple must follow it."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec!r} names axes {missing} the mesh "
                             f"{names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} splits dim {d} in an "
                             f"order other than the mesh's {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec!r} uses axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(d)
    return out


def shard_box(spec, mesh, shape, coordinate) -> tuple[tuple, tuple]:
    """(offset, extent) of the shard of a `shape` tensor laid out as
    `spec` that the device at mesh `coordinate` holds: the box JAX's
    `devices_indices_map` gives that device. Each sharded dim must divide
    (the rules' guard sees to it)."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, coordinate))
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    off, ext = [], []
    for dim, entry in zip(shape, entries):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {axes} ({n} shards)")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        off.append(idx * (dim // n))
        ext.append(dim // n)
    return tuple(off), tuple(ext)


def attn_layout(cfg, tp_size: int) -> str:
    """Legacy single-layout summary (tests/reporting)."""
    q, kv = attn_layouts(cfg, tp_size)
    if q == (TP, None):
        return "heads"
    if q == (None, TP):
        return "head_dim"
    return "replicated"


def attn_layouts(cfg, tp_size: int):
    """((q_heads_spec, q_hd_spec), (kv_heads_spec, kv_hd_spec)).

    Query heads shard over `model` whenever H divides; KV heads shard only
    when Hkv divides — otherwise KV projections/caches stay REPLICATED over
    `model` (they are G-times smaller than Q, and replication avoids the
    per-layer resharding all-to-all that a mismatched head_dim layout
    costs). Archs where H doesn't divide (arctic 56, smollm 15) fall back
    to head_dim sharding for both."""
    if not cfg.n_heads:
        return (None, None), (None, None)
    hd_ok = cfg.resolved_head_dim % tp_size == 0
    if cfg.n_heads % tp_size == 0:
        q = (TP, None)
        kv = (TP, None) if cfg.n_kv_heads % tp_size == 0 else (None, None)
        return q, kv
    if hd_ok:
        return (None, TP), (None, TP)
    return (None, None), (None, None)


# --------------------------------------------------------------------------
# base specs keyed by (tail-of-path pattern). Leaves with extra leading stack
# dims get Nones prepended.
# --------------------------------------------------------------------------
def _param_base_spec(path: tuple, cfg, tp_size: int):
    (qh, qd), (kh, kd) = attn_layouts(cfg, tp_size)

    if path[-1] == "table":                       # embed / lm_head [V, d]
        return (TP, FSDP)
    if path[-2:] == ("wo", "w"):                  # [H, hd, d_model]
        return (qh, qd, FSDP)
    if len(path) >= 2 and path[-2] in ("wq",):
        if path[-1] == "w":                       # [d_model, H, hd]
            return (FSDP, qh, qd)
        return (qh, qd)                           # bias [H, hd]
    if len(path) >= 2 and path[-2] in ("wk", "wv"):
        if path[-1] == "w":                       # [d_model, Hkv, hd]
            return (FSDP, kh, kd)
        return (kh, kd)
    if path[-1] == "router":                      # [d_model, E]
        return (FSDP, None)
    if "experts" in path:
        # expert-parallel over `model` + Megatron col/row parallel over
        # `data` WITHIN each expert: weights are fully sharded with NO
        # ZeRO-3 per-microbatch re-gathers
        if path[-1] in ("gate", "up"):            # [E, d_model, d_ff]
            return (TP, None, FSDP)
        return (TP, FSDP, None)                   # down [E, d_ff, d_model]
    if path[-2:] == ("gate", "w") or path[-2:] == ("up", "w"):
        return (FSDP, TP)                         # ffn in [d_model, d_ff]
    if path[-2:] == ("down", "w"):
        return (TP, FSDP)                         # ffn out [d_ff, d_model]
    if path[-2:] == ("gate", "b") or path[-2:] == ("up", "b"):
        return (TP,)
    if path[-2:] == ("down", "b"):
        return (FSDP,)
    # ---- mamba2 -------------------------------------------------------------
    if path[-2:] == ("wz", "w") or path[-2:] == ("wx", "w"):
        return (FSDP, TP)                         # [d_model, d_inner]
    if path[-2:] == ("wB", "w") or path[-2:] == ("wC", "w"):
        return (FSDP, None)                       # [d_model, N] group-shared
    if path[-2:] == ("wdt", "w"):
        return (FSDP, TP)                         # [d_model, H]
    if path[-2:] == ("out_proj", "w"):
        return (TP, FSDP)                         # [d_inner, d_model]
    if path[-2:] == ("conv_x", "w"):
        return (None, TP)                         # [K, d_inner]
    if path[-2:] == ("conv_x", "b"):
        return (TP,)
    if len(path) >= 2 and path[-2] in ("conv_B", "conv_C"):
        return (None, None) if path[-1] == "w" else (None,)
    if path[-1] in ("A_log", "D", "dt_bias"):
        return (TP,)                              # [H_ssm]
    if path[-2:] == ("wz", "b") or path[-2:] == ("wx", "b"):
        return (TP,)
    if path[-1] in ("b",):                        # remaining 1-D biases
        return (None,)
    return None                      # norms, gates, default: replicate


def _guard(spec_entries, shape, mesh) -> P:
    """Drop axes that don't divide the dim; filter axes absent from mesh."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec_entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in sizes)
        total = math.prod(sizes[a] for a in axes) if axes else 1
        if not axes or dim % total != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


def _pad_entries(names, shape, base) -> tuple:
    """Left-pad a sharding rule's spec entries with None to the array's
    rank. A base spec LONGER than the rank means the sharding table names
    more axes than the tensor has — a table bug, not a caller error."""
    base = tuple(base)
    pad = len(shape) - len(base)
    if pad < 0:
        raise RuntimeError(
            f"sharding rule for {'/'.join(names)} names {len(base)} axes "
            f"{base} but the array only has rank {len(shape)} "
            f"(shape {tuple(shape)}) — fix the param sharding table")
    return (None,) * pad + base


def _map_with_path(fn, tree, names=(), lead=()):
    """`fn(names, leaf, lead)` over a port tree's leaves, in a tree of its
    structure. `names` is the JAX package's path to the leaf (dict keys;
    "[i]" for a tuple or list item) and `lead` the stacked axes in front of
    it: a group of layers under a `STACKED` key adds its list lengths to
    `lead` and nothing to `names`."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in STACKED and isinstance(v, list) and v:
                out[k] = _map_layers(fn, v, STACKED[k], names + (k,), lead)
            else:
                out[k] = _map_with_path(fn, v, names + (k,), lead)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, names + (f"[{i}]",), lead)
                          for i, v in enumerate(tree))
    return fn(names, tree, lead)


def _map_layers(fn, layers, depth, names, lead):
    if depth == 0:
        return _map_with_path(fn, layers, names, lead)
    return [_map_layers(fn, layer, depth - 1, names, lead + (len(layers),))
            for layer in layers]


def _unstacked(spec: P, lead: tuple, names) -> P:
    """A stacked spec without its `lead` entries, which must be None."""
    if any(e is not None for e in tuple(spec)[:len(lead)]):
        raise RuntimeError(f"sharding rule for {'/'.join(names)} shards a "
                           f"stacked layer axis: {spec!r}")
    return P(*tuple(spec)[len(lead):])


def _tp_size(mesh) -> int:
    return axis_sizes(mesh).get(TP, 1)


def param_pspec_tree(cfg, mesh, shapes_tree):
    """Spec tree matching `shapes_tree` (from model.param_shapes)."""
    tp_size = _tp_size(mesh)

    def rule(names, leaf, lead):
        shape = tuple(lead) + tuple(leaf.shape)
        base = _param_base_spec(names, cfg, tp_size)
        if base is None:
            base = ()
        entries = _pad_entries(names, shape, base)
        return _unstacked(_guard(entries, shape, mesh), lead, names)

    return _map_with_path(rule, shapes_tree)


def gathered_once_tree(tree):
    """A tree of `tree`'s structure (a param tree) whose leaves say
    whether the train step gathers that param over the batch axes once a
    step: the embedding and head tables [V, d], read outside the layer
    stack (XLA hoists the reference's gathers of them out of its
    microbatch loop). Every other FSDP leaf is gathered where a layer
    reads it (ZeRO-3)."""
    return _map_with_path(lambda names, leaf, lead: names[-1] == "table",
                          tree)


def _named(mesh, specs):
    return _map_with_path(lambda n, s, lead: NamedSharding(mesh, s), specs)


def param_sharding_tree(cfg, mesh, shapes_tree):
    return _named(mesh, param_pspec_tree(cfg, mesh, shapes_tree))


def opt_sharding_tree(cfg, mesh, shapes_tree):
    """Optimizer-moment shardings: param specs with the FSDP axis widened to
    ('pod', FSDP) — ZeRO-1 across pods (no-op on single-pod meshes)."""
    if "pod" not in mesh.mesh_dim_names:
        return param_sharding_tree(cfg, mesh, shapes_tree)
    sizes = axis_sizes(mesh)
    tp_size = _tp_size(mesh)

    def widen(names, leaf, lead):
        shape = tuple(lead) + tuple(leaf.shape)
        base = _param_base_spec(names, cfg, tp_size) or ()
        spec = _guard(_pad_entries(names, shape, base), shape, mesh)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        widened = False
        for dim, e in zip(shape, entries):
            axes = e if isinstance(e, tuple) else ((e,) if e else ())
            if not widened and FSDP in axes:
                cand = ("pod",) + axes
                total = math.prod(sizes[a] for a in cand)
                if dim % total == 0:
                    out.append(cand)
                    widened = True
                    continue
            out.append(e)
        return NamedSharding(mesh, _unstacked(P(*out), lead, names))

    return _map_with_path(widen, shapes_tree)


# --------------------------------------------------------------------------
# activations / batches / caches
# --------------------------------------------------------------------------
def batch_spec(mesh, rank: int, *, batch_axes=BATCH) -> NamedSharding:
    """Shard dim 0 over the batch axes present in the mesh (guarded)."""
    axes = tuple(a for a in batch_axes if a in mesh.mesh_dim_names)
    return NamedSharding(mesh, P(axes if axes else None,
                                 *([None] * (rank - 1))))


def batch_sharding_for(mesh, sds, *, batch_axes=BATCH):
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in batch_axes if a in sizes)
    total = math.prod(sizes[a] for a in axes) if axes else 1
    if not axes or sds.shape[0] % total != 0:
        return NamedSharding(mesh, P(*([None] * len(sds.shape))))
    return NamedSharding(mesh, P(axes if len(axes) > 1 else axes[0],
                                 *([None] * (len(sds.shape) - 1))))


def batch_sharding_tree(mesh, batch: dict, *, batch_axes=BATCH) -> dict:
    """The placements of a step's inputs: each leaf of `batch` (tokens,
    labels, embeds, ...) sharded on dim 0 over the batch axes
    (`batch_sharding_for`, guarded); None stays None."""
    return {k: None if v is None else
            batch_sharding_for(mesh, v, batch_axes=batch_axes)
            for k, v in batch.items()}


def cache_pspec_tree(cfg, mesh, cache_spec_tree):
    """Decode-cache specs: batch dim over `data`, heads/head_dim over
    `model` per attn_layout; SSM heads over `model`. The port's cache
    trees hold stacked arrays, as the JAX package's do."""
    tp_size = _tp_size(mesh)
    _, (kh, kd) = attn_layouts(cfg, tp_size)
    # decode caches are the capacity-critical tensors: even when the (small)
    # KV *weights* stay replicated for GQA, the cache must shard — fall
    # back to head_dim sharding (partial-dot + tiny score all-reduce).
    if kh is None and kd is None and cfg.n_heads \
            and cfg.resolved_head_dim % tp_size == 0 and tp_size > 1:
        kd = TP

    def rule(names, leaf, lead):
        rank = len(leaf.shape)
        key = names[-1] if names else ""
        entries = [None] * rank
        if key in ("k", "v", "cross_k", "cross_v"):
            # [..., B, S, Hkv, hd] — batch at rank-4, heads at rank-2
            entries[rank - 4] = FSDP
            entries[rank - 2] = kh
            entries[rank - 1] = kd
        elif key == "ssm":
            # [..., B, H, P, N]
            entries[rank - 4] = FSDP
            entries[rank - 3] = TP
        else:
            # conv tails (tuple leaves): [..., B, K-1, C]; C = d_inner -> TP
            entries[rank - 3] = FSDP
            if leaf.shape[-1] == cfg.d_inner:
                entries[rank - 1] = TP
        return _guard(tuple(entries), leaf.shape, mesh)

    return _map_with_path(rule, cache_spec_tree)


def cache_sharding_tree(cfg, mesh, cache_spec_tree):
    return _named(mesh, cache_pspec_tree(cfg, mesh, cache_spec_tree))


def replicated(mesh):
    return NamedSharding(mesh, P())
