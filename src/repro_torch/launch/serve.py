"""Serving launcher: random params (seed 0), or those of the newest
checkpoint under `--ckpt-dir`, and batched greedy generation through
`ServeEngine`, on the CUDA device unless `--device cpu`. Any config but a
vlm's (whose image tokens this launcher has no way to make).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --batch 4 --prompt-len 512 --new-tokens 32 --max-seq 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --ckpt-dir /path/to/ckpt --smoke --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family == "vlm":
        raise ValueError(
            f"{cfg.name} is a vlm: its vision tower is a stub and this "
            f"launcher has no vision embeddings to give it; call "
            f"ServeEngine.generate(prompts, vision_embeds=...) instead")
    dev = resolve_device(args.device)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    params = M.init_params(cfg, 0, device=dev)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        restored = mgr.restore_latest({"params": params})
        if restored is not None:
            params = restored[0]["params"]
            print(f"restored checkpoint step {restored[1]}")
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=args.batch,
                                               max_seq=args.max_seq,
                                               max_new_tokens=args.new_tokens))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    toks = eng.generate(prompts, new_tokens=args.new_tokens)
    for i, row in enumerate(toks.tolist()):
        print(f"req{i}: {row}")
    return toks


if __name__ == "__main__":
    main()
