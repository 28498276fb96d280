"""Train a ~100M-param LM for a few hundred steps with the port's full
stack: AdamW, remat'd flash attention, async JBP checkpoints, restart. Runs
on the CUDA device by default.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        --steps 20 --seq 64

The default config is a 6-layer cut of smollm-360m (~100M params, most of
it embedding); --full uses the real config.
"""
import argparse
import dataclasses
import pathlib
import tempfile

from repro_torch._device import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="use the full config")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = dataclasses.replace(cfg, name=cfg.name + "-100m", n_layers=6,
                                  d_model=512, n_heads=8, n_kv_heads=8,
                                  d_ff=1536, head_dim=None)
    n = cfg.n_params()
    print(f"arch={cfg.name} params={n/1e6:.1f}M steps={args.steps} "
          f"seq={args.seq} batch={args.batch} device={device}")

    workdir = pathlib.Path(tempfile.mkdtemp(prefix="repro-torch-train-"))
    tcfg = TrainerConfig(steps=args.steps, log_every=10,
                         ckpt_every=max(args.steps // 4, 10),
                         seq_len=args.seq, global_batch=args.batch,
                         grad_compression=args.grad_compression)
    hp = AdamWConfig(lr=3e-4, warmup_steps=min(20, args.steps // 5 + 1),
                     total_steps=args.steps)
    out = Trainer(cfg, tcfg, hp, workdir / "ckpt", device=device).run()
    first, last = out["history"][0], out["history"][-1]
    print(f"\nloss {first['loss']:.4f} -> {last['loss']:.4f} "
          f"({last['wall_s']:.1f}s wall)")
    print(f"checkpoints: {workdir / 'ckpt'}")
    return out


if __name__ == "__main__":
    main()
