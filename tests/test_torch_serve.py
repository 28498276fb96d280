"""The port's serving slice against the JAX package: prefill logits and
caches, and `ServeEngine.generate` tokens, for the smoke reductions of one
config of each ported LM family (hybrid, ssm, dense with qkv bias, dense
with qk_norm); the port's own decode against its teacher-forced forward;
the serve launcher on the CPU.

The JAX side runs in a subprocess with `--xla_allow_excess_precision=false`.
XLA's default lets a fusion skip the bf16 roundings the JAX code writes
(`.astype(COMPUTE_DTYPE)`), so which values round depends on fusion choices
(a jitted `mamba2_seq` differs from the eager one in half its outputs).
With the flag off the JAX package rounds where its source says, the port
rounds at the same points, and the two agree: the same tokens, and logits
equal to fp32 rounding but where a sum in another order flips a bf16
rounding. Params are JAX's, carried across as numpy.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.models import model as M
from repro_torch.models.convert import cache_to_numpy, params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServeEngine

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ["zamba2-2.7b", "mamba2-2.7b", "qwen1.5-0.5b", "qwen3-4b"]
BATCH, PROMPT, NEW, MAX_SEQ = 2, 16, 6, 64
#: prefill logits (|values| up to ~1): the port repeats JAX's operations
#: and roundings, but where an fp32 sum taken in another order rounds a
#: bf16 value the other way, the logits of that position and of the later
#: ones that attend to it move by up to ~1e-2 (measured 7.9e-3 dense, 4.7e-3
#: ssm and hybrid); elsewhere they agree to fp32 rounding (~1e-7)
LOGITS_TOL = 1.5e-2
#: caches: within two bf16 ulps of the largest value
CACHE_ULPS = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat):
    tree = {}
    for path, a in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


def _prompts(cfg):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)


def _jax_reference(out_path):
    """Run in a subprocess: JAX params, prefill and generate for CONFIGS,
    saved to one .npz."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduce_for_smoke as jreduce
    from repro.models import model as JM
    from repro.serve.engine import ServeConfig as JServeConfig
    from repro.serve.engine import ServeEngine as JServeEngine

    arrays = {}
    for name in CONFIGS:
        cfg = jreduce(jget(name))
        params = jax.jit(JM.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        prompts = _prompts(cfg)
        logits, cache = jax.jit(lambda p, t, cfg=cfg: JM.prefill(
            p, cfg, {"tokens": t}, q_chunk=MAX_SEQ, kv_chunk=MAX_SEQ))(
                params, jnp.asarray(prompts))
        eng = JServeEngine(cfg, params, JServeConfig(
            max_batch=BATCH, max_seq=MAX_SEQ, max_new_tokens=NEW))
        arrays[f"{name}|tokens"] = eng.generate(prompts, new_tokens=NEW)
        arrays[f"{name}|logits"] = np.asarray(logits)
        for k, v in _flatten(params).items():
            arrays[f"{name}|params|{k}"] = np.asarray(v)
        for k, v in _flatten(cache).items():
            arrays[f"{name}|cache|{k}"] = np.asarray(v).astype(np.float32)
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax-ref") / "ref.npz"
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{flags} --xla_allow_excess_precision=false".strip(),
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    code = f"import test_torch_serve as t; t._jax_reference({str(out)!r})"
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _port(jax_ref, name):
    cfg = reduce_for_smoke(get_config(name))
    pre = f"{name}|params|"
    tree = _unflatten({k[len(pre):]: v for k, v in jax_ref.items()
                       if k.startswith(pre)})
    return cfg, params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits_and_cache_match_jax(jax_ref, name):
    cfg, params = _port(jax_ref, name)
    tokens = torch.from_numpy(_prompts(cfg)).long()
    with torch.inference_mode():
        logits, cache = M.prefill(params, cfg, {"tokens": tokens},
                                  q_chunk=MAX_SEQ, kv_chunk=MAX_SEQ)
    ref = jax_ref[f"{name}|logits"]
    assert logits.shape == ref.shape and logits.dtype == torch.float32
    assert np.abs(logits.numpy() - ref).max() < LOGITS_TOL
    got = _flatten(cache_to_numpy(cache))
    pre = f"{name}|cache|"
    want = {k[len(pre):]: v for k, v in jax_ref.items() if k.startswith(pre)}
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        b = want[k]
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= CACHE_ULPS * 2.0 ** -7 * np.abs(b).max(), k


@pytest.mark.parametrize("name", CONFIGS)
def test_generate_tokens_match_jax(jax_ref, name):
    cfg, params = _port(jax_ref, name)
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=BATCH,
                                               max_seq=MAX_SEQ,
                                               max_new_tokens=NEW))
    got = eng.generate(_prompts(cfg), new_tokens=NEW)
    assert got.dtype == np.int32 and got.shape == (BATCH, NEW)
    np.testing.assert_array_equal(got, jax_ref[f"{name}|tokens"])


def teacher_forcing(eng, cfg, prompts, n_new):
    """Generated tokens, the decode logits of every step, and the logits of
    one teacher-forced forward over prompt + generated tokens at the same
    positions (the model is causal, so position Sp-1+t sees exactly what
    decode step t saw)."""
    Sp = prompts.shape[1]
    gen = eng.generate(prompts, new_tokens=n_new)
    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).long()
        logits, cache = eng.prefill(eng.params, {"tokens": tokens})
        cache = eng._grow_cache(cache)
        steps = [logits[:, -1]]
        for t in range(n_new - 1):
            tok = torch.from_numpy(gen[:, t:t + 1]).long()
            logits, cache = M.decode_step(eng.params, cfg, tok, cache, Sp + t)
            steps.append(logits[:, -1])
        seq = torch.from_numpy(np.concatenate([prompts, gen[:, :-1]], 1))
        full, _ = M.forward(eng.params, cfg, {"tokens": seq.long()},
                            q_chunk=MAX_SEQ, kv_chunk=MAX_SEQ)
    return gen, torch.stack(steps, 1), full[:, Sp - 1:]


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_agrees_with_teacher_forced_forward(name):
    """Decode (recurrent Mamba2 step with a bf16 state, softmax over the
    cache) and the full forward (chunked scan, flash) round at other
    points, so logits agree to ~1e-2 (measured up to 1.4e-2), and a greedy
    token may differ only where the forward's top-1/top-2 margin is within
    twice the measured difference."""
    cfg = reduce_for_smoke(get_config(name))
    params = M.init_params(cfg, 3, device="cpu")
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=BATCH,
                                               max_seq=MAX_SEQ,
                                               max_new_tokens=NEW))
    prompts = _prompts(cfg)
    gen, dec, full = teacher_forcing(eng, cfg, prompts, NEW)
    np.testing.assert_array_equal(dec.argmax(-1).numpy(), gen)
    diff = float((dec - full).abs().max())
    assert diff < 3e-2
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * diff
    same = full.argmax(-1).numpy() == gen
    assert same[clear.numpy()].all()
    assert clear.float().mean() > 0.5


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20",
                       "--new-tokens", "3", "--max-seq", "32"])
    assert toks.shape == (2, 3)
    out = capsys.readouterr().out
    assert "req0:" in out and "req1:" in out
    with pytest.raises(NotImplementedError, match="ckpt/manager.py"):
        serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                    "--ckpt-dir", "somewhere"])


def test_engine_refuses_a_request_over_its_cache_budget():
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    eng = ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"),
                      ServeConfig(max_batch=1, max_seq=20))
    with pytest.raises(ValueError, match="max_seq=20"):
        eng.generate(np.zeros((1, 16), np.int32), new_tokens=5)


def test_engine_holds_bf16_weights_and_fp32_constants():
    cfg = reduce_for_smoke(get_config("zamba2-2.7b"))
    params = M.init_params(cfg, 0, device="cpu")
    eng = ServeEngine(cfg, params, ServeConfig())
    mamba = eng.params["stack"]["units"][0][0]["mamba"]
    assert mamba["wx"]["w"].dtype == torch.bfloat16
    assert mamba["conv_x"]["b"].dtype == torch.bfloat16
    assert eng.params["embed"]["table"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert mamba[name] is params["stack"]["units"][0][0]["mamba"][name]
    assert eng.params["final_norm"]["scale"].dtype == torch.float32
    assert params["embed"]["table"].dtype == torch.float32   # untouched
