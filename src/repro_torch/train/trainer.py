"""Fault-tolerant training loop: the port of the JAX package's
`train/trainer.py`.

Wires together: the train step, the synthetic data pipeline, checkpoints
through the port's `CheckpointManager` (under the JAX package's variable
names, so either package resumes the other's), automatic restart from the
newest valid checkpoint, and a crash-injection hook for the
fault-tolerance tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokens, to_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_keep: int = 3
    seed: int = 0
    seq_len: int = 256
    global_batch: int = 8
    grad_compression: bool = False


class Trainer:
    """`device`: CUDA unless "cpu". `async_write` and `device_compress`
    go to the `CheckpointManager` (a write thread behind the steps; each
    tensor leaf byte-shuffled on its device before the host LZ stage)."""

    def __init__(self, cfg, tcfg: TrainerConfig, hp: AdamWConfig,
                 ckpt_dir, *, engine_config=None, device=None,
                 async_write: bool = True, device_compress: bool = False):
        from repro_torch.core.bp_engine import EngineConfig
        self.cfg = cfg
        self.tcfg = tcfg
        self.hp = hp
        self.device = resolve_device(device)
        self.manager = CheckpointManager(
            ckpt_dir, every=tcfg.ckpt_every, keep_n=tcfg.ckpt_keep,
            engine_config=engine_config or EngineConfig(aggregators=2,
                                                        codec="blosc"),
            async_write=async_write, device_compress=device_compress)
        self.data = SyntheticTokens(cfg.padded_vocab if cfg.family != "audio"
                                    else cfg.vocab_size,
                                    tcfg.seq_len, tcfg.global_batch,
                                    seed=tcfg.seed)
        self.step_fn = make_train_step(
            cfg, hp, grad_compression=tcfg.grad_compression,
            q_chunk=min(256, tcfg.seq_len), kv_chunk=min(256, tcfg.seq_len),
            ssd_chunk=min(64, tcfg.seq_len))
        self.history: list[dict] = []

    def _fresh_state(self):
        return init_train_state(self.cfg, self.tcfg.seed,
                                grad_compression=self.tcfg.grad_compression,
                                device=self.device)

    def _make_batch(self, step: int) -> dict:
        """The JAX package's batch for `step` (numpy): tokens and labels,
        seeded embeddings in place of tokens for the audio family, and
        seeded vision embeddings for the vlm family."""
        b = self.data.batch_at(step)
        if self.cfg.family == "audio":
            emb = np.random.default_rng(step).normal(
                size=(b["tokens"].shape[0], b["tokens"].shape[1],
                      self.cfg.d_model)).astype(np.float32)
            return {"embeds": emb, "labels": b["labels"]}
        if self.cfg.family == "vlm":
            vis = np.random.default_rng(step).normal(
                size=(b["tokens"].shape[0], self.cfg.n_vision_tokens,
                      self.cfg.d_model)).astype(np.float32)
            return {**b, "vision_embeds": vis}
        return b

    def run(self, *, crash_at: Optional[int] = None,
            on_step: Optional[Callable] = None) -> dict:
        """Train to tcfg.steps, resuming from the newest valid checkpoint.
        `crash_at` raises after that step (fault-injection for tests)."""
        state = self._fresh_state()
        restored = self.manager.restore_latest(state)
        if restored is not None:
            state, at = restored
            print(f"[trainer] resumed from checkpoint step {at}")
        start = int(state["step"])
        t0 = time.perf_counter()
        for step in range(start, self.tcfg.steps):
            batch = to_device(self._make_batch(step), self.device)
            state, metrics = self.step_fn(state, batch)
            if (step + 1) % self.tcfg.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                m["wall_s"] = time.perf_counter() - t0
                self.history.append(m)
                print(f"[trainer] step {step+1} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}")
            self.manager.save(state, step + 1)
            if on_step:
                on_step(step + 1, state)
            if crash_at is not None and step + 1 >= crash_at:
                self.manager.wait()
                raise RuntimeError(f"injected crash at step {step+1}")
        self.manager.save(state, self.tcfg.steps, force=True)
        self.manager.wait()
        return {"state": state, "history": self.history}
