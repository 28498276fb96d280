"""Where the mesh phase of `chip_smoke.py` can put its 4 ranks: one card
cannot hold 4 nccl ranks, so the ranks are a gloo group. This script
asks the card, with 4 spawned ranks that all take cuda:0:

1. whether gloo runs the collectives DTensor's redistributions need
   (`all_gather_into_tensor`, `reduce_scatter_tensor`,
   `all_to_all_single`, and `all_reduce`, `broadcast`, `scatter`) on
   CUDA tensors through the c10d API;
2. whether a DTensor train step of the smoke smollm-360m config on a
   (2, 2) ("data", "model") cuda mesh over that group finishes within
   STEP_WAIT_S seconds (each rank prints when its state is laid out and
   when its step is done).

Run on the GPU machine: `python3 chip_mesh_probe.py` (about 2.5 minutes
when the step does not finish). Prints one JSON line a part and exits 0
either way: it reports, it decides nothing.
"""
import json
import multiprocessing as mp
import os
import pathlib
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
STEP_WAIT_S = 120
WORLD = 4


def _collectives(rank, store, q):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    dev = torch.device("cuda", 0)
    x = torch.full((8,), float(rank + 1), device=dev)
    calls = {
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * WORLD, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // WORLD, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(8, device=dev), x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "scatter": lambda: dist.scatter(
            torch.empty(8, device=dev),
            [x.clone() for _ in range(WORLD)] if rank == 0 else None, src=0)}
    res = {}
    for name, fn in calls.items():
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:                       # noqa: BLE001 — told
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"
        dist.barrier()
    q.put((rank, res))
    dist.destroy_process_group()


def _step(rank, store, q):
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.tree import tree_map
    from repro_torch.train.state import (init_train_state,
                                         train_state_shardings)
    from repro_torch.train.step import make_train_step
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=WORLD)
        cfg = reduce_for_smoke(get_config("smollm-360m"))
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cuda")
        state = tree_map(lambda t, s: distribute_tensor(
            t, s.mesh, s.placements, src_data_rank=None),
            init_train_state(cfg, 0), train_state_shardings(cfg, mesh))
        print(f"rank {rank}: state laid out", flush=True)
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=g)
                 .cuda() for k in ("tokens", "labels")}
        t0 = time.perf_counter()
        _, m = make_train_step(cfg, AdamWConfig())(state, batch)
        torch.cuda.synchronize()
        print(f"rank {rank}: stepped", flush=True)
        q.put((rank, {"loss": float(m["loss"]),
                      "step_s": time.perf_counter() - t0}))
    except Exception:                                # noqa: BLE001 — told
        q.put((rank, traceback.format_exc()[-2000:]))


def _pool(target, wait_s: float) -> dict:
    """Run `target` in WORLD spawned ranks; their results, or what came
    within `wait_s` (the others are killed)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = [ctx.Process(target=target, args=(r, store, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    res, deadline = {}, time.monotonic() + wait_s
    try:
        while len(res) < WORLD:
            r, v = q.get(timeout=max(0.1, deadline - time.monotonic()))
            res[r] = v
    except Exception:                                # noqa: BLE001 — partial
        pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_mesh_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    res = _pool(_collectives, 120)
    print(json.dumps({"gloo_cuda_collectives": res,
                      "s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    res = _pool(_step, STEP_WAIT_S)
    print(json.dumps({"gloo_cuda_dtensor_step": res,
                      "finished_ranks": len(res), "wait_s": STEP_WAIT_S,
                      "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
