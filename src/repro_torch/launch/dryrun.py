"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on the
production mesh with fake stand-ins, then derive its roofline terms. The
port of the JAX package's `launch/dryrun.py`.

Where the reference lowers and compiles each cell for 256 or 512 fake
host devices, this traces it in ONE process on a fake process group of
256 or 512 ranks (torch's `fake` backend on a `FakeStore`: collectives
return at once), as rank 0: the mesh is `make_production_mesh`'s, every
param, cache and batch a fake tensor (`FakeTensorMode`: shapes, dtypes
and devices, no memory) at full size, laid out by `launch.shapes.
input_specs` as a DTensor of the rank's local shard. One step runs
(forward and backward and the optimizer for `train_4k`) under
`roofline.trace_analysis.TraceCounter`, which counts each local op; the
port's two kernels run as custom ops with fake outputs and their own flop
formulas. Nothing needs a GPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

Results accumulate in build/dryrun/<arch>__<shape>__<mesh>.json (build/
is not committed); reruns are incremental (use --force to recompute).
A cached cell is not traced again, but its report is rebuilt from its
stored counts by today's `build_report` (`rereport`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, list_configs
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import make_production_mesh, mesh_summary
from repro_torch.launch.sharding import attn_layout
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline.analysis import NODE_GPUS, build_report
from repro_torch.roofline.trace_analysis import (TraceCounter, io_bytes,
                                                 summarize)
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.step import make_train_step

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# Per-shape chunking (the plain versions' chunks; the kernels tile by
# themselves) + gradient-accumulation depth for training, as the
# reference's.
CHUNKS = {
    "train_4k": dict(q_chunk=1024, kv_chunk=1024, ssd_chunk=128,
                     microbatches=8),
    "prefill_32k": dict(q_chunk=1024, kv_chunk=1024, ssd_chunk=128),
    "decode_32k": dict(),
    "long_500k": dict(),
}


def step_fn_for(cfg, kind: str, shape_name: str, tuning: dict | None = None):
    ch = dict(CHUNKS.get(shape_name, {}))
    if tuning:
        ch.update(tuning)
    if kind == "train":
        return make_train_step(cfg, AdamWConfig(), **ch)
    if kind == "prefill":
        return make_prefill_step(cfg, **ch)
    return make_decode_step(cfg)


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of `n_ranks` ranks in this process, as rank 0
    (any group already up is taken down first, and this one after)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _offsets_off_fake():
    """DTensor reckons a shard's global offset with a small real tensor
    (`_utils._compute_local_shape_and_global_offset`, e.g. in an argmax
    over a sharded dim), which a `FakeTensorMode` turns into a fake one
    whose value cannot be read. Its inputs are plain ints (shapes, mesh
    coordinates), so it runs here with the fake mode lifted."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils
    real = _utils._compute_local_shape_and_global_offset

    def offsets(*a, **kw):
        with unset_fake_temporarily():
            return real(*a, **kw)
    _utils._compute_local_shape_and_global_offset = offsets
    try:
        yield
    finally:
        _utils._compute_local_shape_and_global_offset = real


def fake_dtensors(tree, shardings):
    """Fake DTensors (inside an active `FakeTensorMode`) of a tree of meta
    tensors, each laid out by its `NamedSharding`: the rank's local shard
    of the right shape and dtype, the global shape and stride given."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: fake_dtensors(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_dtensors(v, s) for v, s in
                          zip(tree, shardings))
    pl = tuple(shardings.placements)
    shape = tuple(tree.shape)
    local = list(shape)
    for i, q in enumerate(pl):          # the rules' guard: even shards
        if q.is_shard():
            local[q.dim] //= shardings.mesh.size(i)
    t = torch.empty(tuple(local), dtype=tree.dtype)
    return DTensor.from_local(t, shardings.mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=make_contiguous_strides_for(shape))


def _local_bytes(tree) -> float:
    from repro_torch.meshctx import is_dtensor
    from repro_torch.models.model import leaves
    total = 0.0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if is_dtensor(t) else t
            total += loc.numel() * loc.element_size()
    return total


def trace_cell(cfg, shape_name: str, mesh, *, tuning=None) -> dict:
    """Trace one step of `cfg` at `shape_name` on `mesh` with fake inputs:
    (counts of `trace_analysis.summarize` with the step's
    `io_bytes_per_device`, memory analysis, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    spec = SH.input_specs(cfg, shape_name, mesh)
    fn = step_fn_for(cfg, spec["kind"], shape_name, tuning)
    case = spec["case"]
    t0 = time.time()
    with FakeTensorMode(), _offsets_off_fake():
        args = list(fake_dtensors(a, s) for a, s in
                    zip(spec["args"], spec["in_shardings"]))
        if spec["kind"] == "decode":
            args[3] = case.seq - 1          # the cache's last slot
        arg_bytes = _local_bytes([a for a in args
                                  if isinstance(a, (dict, torch.Tensor))])
        grad = spec["kind"] == "train"
        with torch.set_grad_enabled(grad), TraceCounter() as counter:
            out = fn(*args)
        out_bytes = _local_bytes(out[1] if spec["kind"] == "decode"
                                 else out)
        io = io_bytes(args, out)
    counts = {**summarize(counter), "io_bytes_per_device": io}
    alias = (_local_bytes(args[1]) if spec["kind"] == "decode" else
             _local_bytes(args[0]) if grad else 0.0)
    mem = {"argument_bytes": arg_bytes,
           "output_bytes": 0.0 if spec["kind"] != "prefill" else out_bytes,
           "temp_bytes": counts["peak_bytes_per_device"],
           "alias_bytes": alias}
    return {"counts": counts, "memory_analysis": mem,
            "trace_s": time.time() - t0, "case": case, "kind": spec["kind"]}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, tuning=None,
             verbose=True) -> dict:
    cfg = get_config(arch)
    ok, why = SH.applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        res = trace_cell(cfg, shape_name, mesh, tuning=tuning)
        n_devices = int(math.prod(mesh.shape))
        info = mesh_summary(mesh)
        layout = attn_layout(cfg, int(mesh.shape[
            mesh.mesh_dim_names.index("model")]))
    case = res["case"]
    mem = res["memory_analysis"]
    rep = build_report(arch=arch, shape=shape_name, mesh_name=mesh_kind,
                       n_devices=n_devices, counts=res["counts"], cfg=cfg,
                       kind=case.kind, seq=case.seq, batch=case.batch,
                       mem_stats=mem)
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "ok", "kind": case.kind, "mesh_info": info,
           "attn_layout": layout, "trace_s": res["trace_s"],
           "ops": res["counts"]["ops"], "memory_analysis": mem,
           "roofline": rep.to_dict()}
    if verbose:
        r = rep
        print(f"[{arch} x {shape_name} x {mesh_kind}] "
              f"trace={res['trace_s']:.1f}s "
              f"compute={r.compute_s*1e3:.3f}ms "
              f"memory={r.memory_s*1e3:.3f}ms "
              f"(lower {r.memory_lower_s*1e3:.3f}ms) "
              f"collective={r.collective_s*1e3:.3f}ms "
              f"dominant={r.dominant} "
              f"useful={r.useful_flops_ratio:.3f} "
              f"mfu_bound={r.mfu_bound:.3f} "
              f"args={mem['argument_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_bytes']/2**30:.2f}GiB fits={r.fits_hbm}",
              flush=True)
    return out


def rereport(prev: dict) -> dict:
    """A cached cell with its report rebuilt by today's `build_report`
    from the counts it stored. A cell stored before the report split its
    collective traffic by node has no split: all of it is taken as
    crossing nodes, which is exact when no group of the cell's mesh lies
    within one node (ranks row-major, a node NODE_GPUS consecutive ranks:
    every axis of size n and stride st has n * st > NODE_GPUS; the
    production meshes' axes are 16 wide or strided by 16). Raises for
    another mesh: trace that cell again (`--force`)."""
    r = prev["roofline"]
    cross = r.get("collective_cross_node_bytes_per_device")
    if cross is None:
        shape = prev["mesh_info"]["shape"]
        if any(n > 1 and n * math.prod(shape[i + 1:]) <= NODE_GPUS
               for i, n in enumerate(shape)):
            raise ValueError(f"{prev['arch']} {prev['shape']} "
                             f"{prev['mesh']}: a group may lie within a "
                             f"node; trace the cell again (--force)")
        cross = r["collective_bytes_per_device"]
    case = SH.SHAPE_TABLE[prev["shape"]]
    counts = {"flops_per_device": r["flops_per_device"],
              "hbm_bytes_per_device": r["hbm_bytes_per_device"],
              "collective_traffic_per_device":
                  r["collective_bytes_per_device"],
              "collective_traffic_by_kind": r["collective_by_kind"],
              "collective_op_counts": r["collective_op_counts"],
              "product_flops_per_device": r["product_flops_per_device"],
              "collective_traffic_cross_node": cross,
              "io_bytes_per_device": r.get("io_bytes_per_device", 0.0)}
    rep = build_report(arch=prev["arch"], shape=prev["shape"],
                       mesh_name=prev["mesh"], n_devices=r["n_devices"],
                       counts=counts, cfg=get_config(prev["arch"]),
                       kind=case.kind, seq=case.seq, batch=case.batch,
                       mem_stats=prev["memory_analysis"])
    if rep.model_flops != r["model_flops"]:
        raise ValueError(f"{prev['arch']} {prev['shape']}: the shape table "
                         f"moved since the cell was traced")
    return {**prev, "roofline": rep.to_dict()}


def cell_path(arch, shape, mesh_kind) -> pathlib.Path:
    return RESULTS_DIR / f"{arch}__{shape}__{mesh_kind}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = (list(SH.SHAPE_TABLE) if (args.all or not args.shape)
              else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = cell_path(arch, shape, mesh_kind)
                if path.exists() and not args.force:
                    prev = json.loads(path.read_text())
                    if prev.get("status") == "ok":
                        prev = rereport(prev)
                        path.write_text(json.dumps(prev, indent=1,
                                                   default=str))
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[{arch} x {shape} x {mesh_kind}] cached "
                              f"({prev['status']})")
                        continue
                try:
                    out = run_cell(arch, shape, mesh_kind)
                except Exception as e:  # noqa: BLE001
                    out = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures.append((arch, shape, mesh_kind, repr(e)))
                    print(f"[{arch} x {shape} x {mesh_kind}] ERROR: {e!r}",
                          flush=True)
                path.write_text(json.dumps(out, indent=1, default=str))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\ndry-run complete: all requested cells OK")


if __name__ == "__main__":
    main()
