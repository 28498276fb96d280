"""The port (`repro_torch`) stands alone: it never imports JAX or any module
of the JAX package, and its entry points refuse to fall back to the CPU
unless asked to."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""

_BANNED = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)\b(?!_))",
    re.M)


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True, cwd=REPO)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.pic.simulation" in res["modules"]
    assert "repro_torch.ckpt.checkpoint" in res["modules"]
    assert "repro_torch.core.compression" in res["modules"]
    for name in ("configs.base", "models.model", "models.convert",
                 "models.moe", "models.transformer",
                 "kernels.flash_attention.ops", "kernels.ssd_scan.ops",
                 "serve.engine", "launch.serve", "launch.distributed",
                 "core.shm_transport", "core.parallel_engine",
                 "ckpt.manager", "core.original_io", "core.sst_engine",
                 "insitu.reducers", "insitu.runner", "optim.adamw",
                 "optim.grad_compress", "data.pipeline", "train.state",
                 "train.step", "train.trainer", "launch.train",
                 "examples.sst_streaming", "examples.quickstart",
                 "examples.train_lm"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["bad"] == []


def test_port_sources_and_chip_smoke_have_no_jax_or_repro_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _BANNED.finditer(f.read_text())]
    assert hits == []


def test_banned_import_pattern_catches_what_it_should():
    for bad in ("import jax\n", "from jax import numpy\n",
                "    import repro.core\n", "from repro.core import x\n",
                "from repro import core\n", "import jax.numpy as jnp\n"):
        assert _BANNED.search(bad), bad
    for ok in ("import repro_torch\n", "from repro_torch.core import x\n",
               "# mentions repro.core in prose\n"):
        assert not _BANNED.search(ok), ok


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch._device import resolve_device
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.examples import pic_simulation
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.pic.convert import state_from_numpy, state_to_numpy
    from repro_torch.pic.simulation import PicConfig, init_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PicConfig(n_cells=16, capacity=64, n_electrons=8, n_ions=8,
                    n_neutrals=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_sim(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pic_simulation.main(["--steps", "1", "--scale", "4096"])
    state = init_sim(cfg, 0, device="cpu")
    assert state.electrons.x.device.type == "cpu"
    flat = state_to_numpy(state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy(flat)
    assert state_from_numpy(flat, "cpu").ions.v.shape == (64, 3)
    assert resolve_device("cpu") == torch.device("cpu")

    lm = reduce_for_smoke(get_config("zamba2-2.7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(lm, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "zamba2-2.7b", "--smoke"])
    params = M.init_params(lm, 0, device="cpu")
    tree = {k: {n: t.numpy() for n, t in v.items()} for k, v in params.items()
            if k != "stack"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(lm, tree)
    assert params_from_numpy(lm, tree, device="cpu")["embed"][
        "table"].device.type == "cpu"
    toks = serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                       "--batch", "1", "--prompt-len", "8",
                       "--new-tokens", "2", "--max-seq", "16"])
    assert toks.shape == (1, 2)


def test_training_and_streaming_entry_points_raise_without_a_card(
        monkeypatch, tmp_path):
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.examples import quickstart, sst_streaming, train_lm
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    for call in (lambda: init_train_state(cfg),
                 lambda: Trainer(cfg, TrainerConfig(), AdamWConfig(),
                                 tmp_path / "ckpt"),
                 lambda: train.main(["--arch", "smollm-360m", "--smoke",
                                     "--ckpt-dir", str(tmp_path / "c")]),
                 lambda: sst_streaming.main([]),
                 lambda: quickstart.main([]),
                 lambda: train_lm.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state = init_train_state(cfg, device="cpu")
    assert int(state["step"]) == 0
    assert state["opt"]["m"]["embed"]["table"].dtype == torch.float32
