"""Whether a DTensor train step of 4 gloo ranks sharing one card
finishes: torch's gloo lacks one functional collective for CUDA tensors,
and `launch.distributed.repair_gloo_cuda_gather` supplies it, so
`chip_smoke.py`'s mesh phase can keep its ranks' tensors on the card
(`MESH_DEVICE`).

One card cannot hold 4 nccl ranks, so the ranks would be a gloo group
whose tensors lie on cuda:0. This script runs the smallest cases of that
in 4 spawned ranks, once a variant, with the diagnostics that tell a wait
apart from an error or a crash:

- `TORCH_DISTRIBUTED_DEBUG=DETAIL`: the process-group wrapper checks each
  collective's kind and shapes across the ranks before it runs, so a
  mismatch is raised as an error that names it;
- `faulthandler`: every thread's Python stack, the autograd engine's
  device thread's too, is dumped to `<out>/<variant>.rank<r>.stacks`
  every STACK_EVERY_S seconds until the rank finishes, and on a fatal
  signal;
- a log of each collective the rank issues (its kind, shape, dtype and
  group size, and the thread that issued it) and of each DTensor
  redistribution, in `<out>/<variant>.rank<r>.log`.

The variants: `funcol:<op>`, one functional collective of those
DTensor's redistributions issue (`_functional_collectives`, waited on)
on a CUDA tensor, as torch has it, or `funcol:c10d_all_gather`, the c10d
`all_gather_into_tensor` beside it; `repaired:all_gather_tensor`, the
functional all-gather with the repair installed, byte for byte against
the c10d gather (fp32, bf16, and the padded shards of a DTensor); `step`,
a train step of the smoke smollm-360m config on a (2, 2) ("data",
"model") cuda mesh from `make_mesh` (which installs the repair), with
each rank's flash launches, and a kernel that raises, naming itself, for
the other functional gathers (`TRIPWIRES`), so the log shows whether the
step reaches one; `detail`, the same step with the DETAIL wrapper, which
only this variant runs.

What it showed on an H100 with torch 2.11 (PERF.md §7): the functional
all-gather (`_c10d_functional.all_gather_into_tensor`, which reaches the
backend's `allgather_into_tensor_coalesced`) kills every rank with
SIGSEGV (exit -11), as torch has it; the c10d `all_gather_into_tensor`
and the other functional collectives complete. With the repair the
functional gather equals the c10d one byte for byte (fp32, bf16, padded
DTensor shards), the smoke step completes on all 4 ranks with their
params on cuda:0, 8 flash launches a rank and the same loss on each,
and reaches no other functional gather (no tripwire fired). Under DETAIL
a step whose backward reduce-scatters raised "Backend gloo does not
support reduce_scatter_tensor_coalesced" there; the step reduces its
gradients with all-reduces since, and completes under DETAIL too.

Run on the GPU machine: `python3 chip_mesh_probe.py [variant ...] [--out
DIR]` (all variants by default; the files under DIR, `build/mesh_probe`
by default; about STEP_WAIT_S seconds a variant that does not finish).
Prints one JSON line a variant (with each rank's exit code: None while
it still ran at the deadline) and exits 0 either way: it reports, it
decides nothing.
"""
import argparse
import collections
import json
import multiprocessing as mp
import os
import pathlib
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
STEP_WAIT_S = 100
FUNCOL_WAIT_S = 45
STACK_EVERY_S = 20
WORLD = 4
FUNCOL = ("all_gather_tensor", "c10d_all_gather", "all_reduce",
          "reduce_scatter_tensor", "all_to_all_single", "broadcast")
VARIANTS = tuple(f"funcol:{op}" for op in FUNCOL) + (
    "repaired:all_gather_tensor", "step", "detail")
#: the functional gathers besides the repaired one: a rank that reaches
#: one raises, naming it, where gloo would kill it
TRIPWIRES = ("all_gather_into_tensor_out", "all_gather_into_tensor_coalesced")


def _trace_collectives(log):
    """Log every functional collective and DTensor redistribution this
    process issues, with the issuing thread, to `log` (flushed a line)."""
    import threading
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor._redistribute as red
    n = [0]

    def note(what):
        th = threading.current_thread()
        n[0] += 1
        log.write(f"{n[0]} {time.perf_counter():.4f} "
                  f"[{th.name}:{threading.get_ident()}] {what}\n")
        log.flush()

    def wrap(mod, name):
        real = getattr(mod, name)

        def fn(*a, **kw):
            t = a[0] if a else None
            shape = (tuple(t.shape), str(t.dtype)) if hasattr(t, "shape") \
                else type(t).__name__
            note(f"{mod.__name__.rsplit('.', 1)[-1]}.{name} {shape}")
            return real(*a, **kw)
        setattr(mod, name, fn)

    for name in ("all_reduce", "all_gather_tensor", "reduce_scatter_tensor",
                 "all_to_all_single", "broadcast", "all_reduce_coalesced",
                 "all_gather_tensor_autograd",
                 "reduce_scatter_tensor_autograd"):
        if hasattr(funcol, name):
            wrap(funcol, name)
    for name in ("all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "broadcast", "all_to_all_single",
                 "barrier", "all_gather_object", "scatter"):
        wrap(dist, name)
    real = red.redistribute_local_tensor

    def redistribute(local, cur, tgt, *a, **kw):
        if cur.placements != tgt.placements:
            note(f"redistribute {cur.placements} -> {tgt.placements} "
                 f"{tuple(local.shape)} {local.dtype}")
        return real(local, cur, tgt, *a, **kw)
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("torch.distributed.tensor") \
                and getattr(mod, "redistribute_local_tensor", None) is real:
            mod.redistribute_local_tensor = redistribute
    return note


def _funcol(op, note):
    """One functional collective on a CUDA tensor, waited on: 'ok' and
    the sum of its output, or the error."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    group = dist.group.WORLD
    x = torch.arange(8, dtype=torch.float32, device="cuda") + dist.get_rank()

    def c10d_all_gather():
        out = torch.empty(8 * WORLD, device="cuda")
        dist.all_gather_into_tensor(out, x)
        return out
    calls = {
        "all_gather_tensor": lambda: funcol.all_gather_tensor(x, 0, group),
        "c10d_all_gather": c10d_all_gather,
        "reduce_scatter_tensor": lambda: funcol.reduce_scatter_tensor(
            x, "sum", 0, group),
        "all_reduce": lambda: funcol.all_reduce(x, "sum", group),
        "all_to_all_single": lambda: funcol.all_to_all_single(
            x, None, None, group),
        "broadcast": lambda: funcol.broadcast(x, 0, group)}
    note(f"phase: {op} issued")
    try:
        out = funcol.wait_tensor(calls[op]())
        torch.cuda.synchronize()
        res = f"ok {out.sum().item()}"
    except Exception as e:                           # noqa: BLE001 — told
        res = f"{type(e).__name__}: {str(e)[:300]}"
    note(f"phase: {op} {res}")
    return res


def _repaired_gathers(note):
    """With the repair installed, the functional all-gather of CUDA
    tensors (fp32 [8], bf16 [6, 5], and the padded shards DTensor gathers
    for a [10, 3] tensor split 4 ways) against the c10d gather of the
    same inputs, byte for byte: 'ok equal' and the shapes, or what
    differed."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.distributed import repair_gloo_cuda_gather
    repair_gloo_cuda_gather()
    r, group = dist.get_rank(), dist.group.WORLD
    g = torch.Generator().manual_seed(r)
    cases = [torch.arange(8, dtype=torch.float32) + r,
             torch.randn(6, 5, generator=g).to(torch.bfloat16)]
    bad = []
    for x in cases:
        x = x.cuda()
        got = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, group))
        want = torch.empty_like(got)
        dist.all_gather_into_tensor(want, x)
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            bad.append(f"{tuple(x.shape)} {x.dtype}")
    note("phase: lone gathers compared")
    mesh = init_device_mesh("cuda", (WORLD,))
    whole = torch.arange(30, dtype=torch.float32).reshape(10, 3).cuda()
    t = distribute_tensor(whole, mesh, [Shard(0)])
    if not torch.equal(t.full_tensor(), whole):
        bad.append("padded [10, 3] full_tensor")
    torch.cuda.synchronize()
    return "ok equal" if not bad else f"DIFFER {bad}"


def _tripwires(note):
    """Register a CUDA kernel for each of TRIPWIRES that notes it and
    raises: the step's log then shows whether DTensor reaches one."""
    import torch
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def wire(name):
        def fn(*a, **kw):
            note(f"reached _c10d_functional.{name}")
            raise RuntimeError(f"reached _c10d_functional.{name}")
        return fn
    for name in TRIPWIRES:
        lib.impl(name, wire(name), "CUDA")
    return lib


def _rank(rank, store, variant, out, q):
    """One rank of `variant`: its result (or traceback) goes to `q`, its
    collectives to its log, its stacks to its stacks file."""
    import faulthandler
    sys.path.insert(0, str(ROOT / "src"))
    if variant == "detail":
        os.environ["TORCH_DISTRIBUTED_DEBUG"] = "DETAIL"
    import torch
    import torch.distributed as dist
    name = variant.replace(":", "_")
    stacks = open(out / f"{name}.rank{rank}.stacks", "w")
    log = open(out / f"{name}.rank{rank}.log", "w")
    faulthandler.enable(file=stacks, all_threads=True)
    faulthandler.dump_traceback_later(STACK_EVERY_S, repeat=True,
                                      file=stacks)
    try:
        note = _trace_collectives(log)
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs.base import get_config, reduce_for_smoke
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.optim.tree import tree_leaves, tree_map
        from repro_torch.train import step as step_mod
        from repro_torch.train.state import (init_train_state,
                                             train_state_shardings)
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=WORLD)
        if variant.startswith("funcol:"):
            q.put((rank, _funcol(variant.split(":", 1)[1], note)))
            return
        if variant.startswith("repaired:"):
            q.put((rank, _repaired_gathers(note)))
            return
        from repro_torch.kernels.flash_attention import ops as fops
        wires = _tripwires(note)                       # noqa: F841 — held
        cfg = reduce_for_smoke(get_config("smollm-360m"))
        # make_mesh installs the repair: a gloo group on "cuda"
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cuda")
        state = tree_map(lambda t, s: distribute_tensor(
            t, s.mesh, s.placements, src_data_rank=None),
            init_train_state(cfg, 0), train_state_shardings(cfg, mesh))
        note("phase: state laid out")
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=g)
                 .cuda() for k in ("tokens", "labels")}
        t0 = time.perf_counter()
        _, m = step_mod.make_train_step(cfg, AdamWConfig())(state, batch)
        torch.cuda.synchronize()
        note("phase: stepped")
        q.put((rank, {"loss": float(m["loss"]),
                      "step_s": time.perf_counter() - t0,
                      "flash_launches": fops.flash_attention.launches,
                      "params_on": str(tree_leaves(state["params"])[0]
                                       .to_local().device)}))
    except Exception:                                # noqa: BLE001 — told
        q.put((rank, traceback.format_exc()[-3000:]))
    finally:
        faulthandler.cancel_dump_traceback_later()
        log.flush()
        stacks.flush()


def _pool(variant: str, wait_s: float, out: pathlib.Path
          ) -> tuple[dict, list]:
    """Run the variant in WORLD spawned ranks: their results, or what came
    within `wait_s`, and each rank's exit code then (None: still running;
    it is killed)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = [ctx.Process(target=_rank, args=(r, store, variant, out, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    res, deadline = {}, time.monotonic() + wait_s
    while len(res) < WORLD and time.monotonic() < deadline:
        try:
            r, v = q.get(timeout=1.0)
            res[r] = v
        except Exception:                            # noqa: BLE001 — waits
            # a rank that died will not answer: stop once all that have
            # not answered are gone
            if all(not p.is_alive() for i, p in enumerate(procs)
                   if i not in res):
                break
    for p in procs:
        p.join(timeout=5)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return res, codes


def _summary(variant: str, logs: pathlib.Path) -> dict:
    """Each rank's collectives by thread, its last lines, and the first
    collective at which the ranks' sequences differ."""
    seqs, out = {}, {}
    for r in range(WORLD):
        path = logs / f"{variant.replace(':', '_')}.rank{r}.log"
        lines = path.read_text().splitlines() if path.exists() else []
        calls = [ln.split(" ", 2)[2] for ln in lines if " phase: " not in ln]
        seqs[r] = [c.split("] ", 1)[1] for c in calls]
        threads = collections.Counter(c.split("]", 1)[0] + "]"
                                      for c in calls)
        out[f"rank{r}"] = {"n": len(calls), "threads": dict(threads),
                           "last": lines[-4:]}
    n = min(len(s) for s in seqs.values())
    first = next((i for i in range(n)
                  if len({seqs[r][i] for r in seqs}) > 1), None)
    out["first_difference"] = (None if first is None else
                               {r: seqs[r][first] for r in seqs})
    out["first_difference_at"] = first
    return out


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Run 4 gloo ranks on cuda:0 through the variants and "
                    "report each rank's result, exit code and collectives.")
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "mesh_probe")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_mesh_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}; kernel build "
          f"{_build.build_all():.1f} s", flush=True)
    for variant in args.variants:
        t0 = time.perf_counter()
        wait = FUNCOL_WAIT_S if variant.startswith("funcol:") else STEP_WAIT_S
        res, codes = _pool(variant, wait, out)
        print(json.dumps({"variant": variant, "finished_ranks": len(res),
                          "results": res, "exit_codes": codes,
                          "wait_s": wait,
                          "s": time.perf_counter() - t0,
                          "trace": _summary(variant, out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
