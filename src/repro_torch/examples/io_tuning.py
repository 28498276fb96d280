"""The paper's optimization story in one script: sweep aggregators,
compressors, and stripe settings for a fixed checkpoint-like workload, and
print the Fig-6/7/9-style comparison with Darshan cost attribution.

    PYTHONPATH=src python -m repro_torch.examples.io_tuning

Host-only, as the JAX package's `examples/io_tuning.py` is: the writer
takes numpy arrays, so there is no `--device` flag.
"""
import pathlib
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core.bp_engine import BpWriter, EngineConfig
from repro_torch.core.darshan import MONITOR
from repro_torch.core.striping import StripeConfig

GiB = 1024 ** 3


def pic_payload(rank: int, nbytes: int) -> dict[str, np.ndarray]:
    """Per-rank diagnostic-like arrays (smooth floats — compressible like
    real particle/field data, unlike pure noise)."""
    n = nbytes // 4
    rng = np.random.default_rng(rank)
    base = np.cumsum(rng.normal(scale=1e-3, size=n).astype(np.float32))
    return {"particles": base}


def one(tag, cfg, n_ranks=64, bytes_per_rank=512 * 1024, steps=2):
    MONITOR.reset()
    d = pathlib.Path(tempfile.mkdtemp(prefix="repro-tune-"))
    try:
        t0 = time.perf_counter()
        w = BpWriter(d / "s.bp4", n_ranks, cfg)
        total = 0
        for s in range(steps):
            w.begin_step(s)
            for r in range(n_ranks):
                arr = pic_payload(r, bytes_per_rank)["particles"]
                total += arr.nbytes
                w.put("p/x", arr, global_shape=(arr.size * n_ranks,),
                      offset=(arr.size * r,), rank=r)
            w.end_step()
        w.close()
        dt = time.perf_counter() - t0
        stored = MONITOR.report()["total"]["POSIX_BYTES_WRITTEN"]
        cost = MONITOR.cost_per_process(n_ranks)
        print(f"{tag:42s} {total/dt/GiB:7.3f} GiB/s  ratio={total/stored:5.2f} "
              f"meta/proc={cost['meta_s']*1e3:6.2f}ms")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main():
    print(f"{'configuration':42s} {'throughput':>10s}")
    for m in (1, 4, 16, 64):
        one(f"aggregators={m}", EngineConfig(aggregators=m, workers=4))
    for codec in ("none", "blosc", "bzip2"):
        one(f"codec={codec} (1 AGGR)",
            EngineConfig(aggregators=1, codec=codec, workers=4))
    for c, s in ((1, 1 << 20), (4, 1 << 20), (4, 1 << 18), (8, 1 << 16)):
        one(f"stripe count={c} size={s >> 10}KiB (blosc, 1 AGGR)",
            EngineConfig(aggregators=1, codec="blosc", workers=4,
                         stripe=StripeConfig(c, s), n_osts=8))


if __name__ == "__main__":
    main()
