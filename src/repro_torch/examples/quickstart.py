"""Quickstart of the port: train a small LM with openPMD/JBP
checkpointing, crash it, resume it, then serve it. Runs on the CUDA device
by default.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse
import pathlib
import tempfile

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.core.darshan import MONITOR
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    workdir = pathlib.Path(tempfile.mkdtemp(prefix="repro-torch-quickstart-"))
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    steps = args.steps
    every = max(steps // 4, 1)
    tcfg = TrainerConfig(steps=steps, log_every=every, ckpt_every=every,
                         seq_len=128, global_batch=8)
    hp = AdamWConfig(lr=2e-3, warmup_steps=max(steps // 8, 1),
                     total_steps=steps)
    crash_at = every * 2 + every // 2

    print(f"== phase 1: train, crash at step {crash_at} ==")
    try:
        Trainer(cfg, tcfg, hp, workdir / "ckpt", device=device).run(
            crash_at=crash_at)
    except RuntimeError as e:
        print(f"   {e}")

    print("== phase 2: auto-resume from the newest valid checkpoint ==")
    out = Trainer(cfg, tcfg, hp, workdir / "ckpt", device=device).run()

    print("== phase 3: greedy serving ==")
    eng = ServeEngine(cfg, out["state"]["params"],
                      ServeConfig(max_batch=2, max_seq=160, max_new_tokens=8))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    toks = eng.generate(prompts)
    print("   generated:", toks.tolist())

    print("== darshan I/O report ==")
    cost = MONITOR.cost_per_process()
    print(f"   per-process read={cost['read_s']:.4f}s "
          f"write={cost['write_s']:.4f}s meta={cost['meta_s']:.4f}s")
    print(f"   workdir: {workdir}")
    return out


if __name__ == "__main__":
    main()
