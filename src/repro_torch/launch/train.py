"""Training launcher, on the CUDA device unless `--device cpu`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 100 --seq 256 --batch 8 --ckpt-dir /path/to/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 20 --seq 64 --batch 4 --device cpu

`--smoke` substitutes the reduced config (same code path). Without
`--ckpt-dir` the checkpoints go to a fresh temporary directory.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.core.bp_engine import EngineConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--aggregators", type=int, default=4)
    ap.add_argument("--codec", default="blosc")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    tcfg = TrainerConfig(steps=args.steps, log_every=10,
                         ckpt_every=args.ckpt_every, seq_len=args.seq,
                         global_batch=args.batch,
                         grad_compression=args.grad_compression)
    hp = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                     total_steps=args.steps)
    engine = EngineConfig(aggregators=args.aggregators, codec=args.codec,
                          workers=4)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-torch-ckpt-")
    tr = Trainer(cfg, tcfg, hp, ckpt_dir, engine_config=engine,
                 device=args.device)
    out = tr.run()
    h = out["history"]
    print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; "
          f"checkpoints in {ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
