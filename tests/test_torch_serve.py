"""The port's serving slice against the JAX package: prefill logits and
caches, and `ServeEngine.generate` tokens, for the smoke reductions of
configs of every LM family (hybrid, ssm, dense with qkv bias, dense with
qk_norm, moe with a dense first layer and shared experts, moe with a dense
residual, vlm); the port's own decode against its teacher-forced forward;
the serve launcher on the CPU.

The vlm's cross blocks have their tanh gates at 1.0 on both sides (they
initialise at 0, which makes a cross block a no-op), and both packages get
the same seeded vision embeddings.

The JAX side runs in a subprocess with `--xla_allow_excess_precision=false`.
XLA's default lets a fusion skip the bf16 roundings the JAX code writes
(`.astype(COMPUTE_DTYPE)`), so which values round depends on fusion choices
(a jitted `mamba2_seq` differs from the eager one in half its outputs).
With the flag off the JAX package rounds where its source says, the port
rounds at the same points, and the two agree: the same tokens, and logits
equal to fp32 rounding but where a sum in another order flips a bf16
rounding. Params are JAX's, carried across as numpy.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.models import model as M
from repro_torch.models.convert import cache_to_numpy, params_from_numpy
from repro_torch.serve.engine import ServeConfig, ServeEngine, cache_batch

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ["zamba2-2.7b", "mamba2-2.7b", "qwen1.5-0.5b", "qwen3-4b",
           "deepseek-moe-16b", "arctic-480b", "llama-3.2-vision-90b"]
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


def _vision(cfg):
    """Seeded image tokens [BATCH, n_vision_tokens, d_model] of a vlm
    config (fp32; both packages round them to bf16), else None."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(1).normal(
        size=(BATCH, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def open_gates(params, ones_like):
    """The vlm cross blocks' tanh gates at 1.0 (stacked [U, 1] leaves in
    the JAX package, a list of blocks in the port)."""
    cross = params["stack"]["cross"]
    for name in ("attn_gate", "ffn_gate"):
        if isinstance(cross, dict):
            cross[name] = ones_like(cross[name])
        else:
            for block in cross:
                block[name] = ones_like(block[name])
    return params


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
        batch = {}
        vision = _vision(cfg)
        if vision is not None:
            params = open_gates(params, jnp.ones_like)
            batch["vision_embeds"] = jnp.asarray(vision)
        prompts = _prompts(cfg)
        logits, cache = jax.jit(lambda p, t, b, cfg=cfg: JM.prefill(
            p, cfg, {"tokens": t, **b}, q_chunk=MAX_SEQ, kv_chunk=MAX_SEQ))(
                params, jnp.asarray(prompts), batch)
        eng = JServeEngine(cfg, params, JServeConfig(
            max_batch=BATCH, max_seq=MAX_SEQ, max_new_tokens=NEW))
        arrays[f"{name}|tokens"] = eng.generate(prompts, new_tokens=NEW,
                                                vision_embeds=vision)
        arrays[f"{name}|logits"] = np.asarray(logits)
        for k, v in _flatten(params).items():
            # npz keeps no bfloat16: such leaves (arctic's bf16 masters)
            # go as float32 with a flag, exact
            arrays[f"{name}|params|{k}"] = np.asarray(v).astype(np.float32)
            if v.dtype == jnp.bfloat16:
                arrays[f"{name}|bf16|{k}"] = np.array(True)
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
    tree = _unflatten({
        k[len(pre):]: (v.astype(ml_dtypes.bfloat16)
                       if f"{name}|bf16|{k[len(pre):]}" in jax_ref else v)
        for k, v in jax_ref.items() if k.startswith(pre)})
    return cfg, params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits_and_cache_match_jax(jax_ref, name):
    cfg, params = _port(jax_ref, name)
    batch = {"tokens": torch.from_numpy(_prompts(cfg)).long()}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(_vision(cfg))
    with torch.inference_mode():
        logits, cache = M.prefill(params, cfg, batch, q_chunk=MAX_SEQ,
                                  kv_chunk=MAX_SEQ)
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
    got = eng.generate(_prompts(cfg), new_tokens=NEW,
                       vision_embeds=_vision(cfg))
    assert got.dtype == np.int32 and got.shape == (BATCH, NEW)
    np.testing.assert_array_equal(got, jax_ref[f"{name}|tokens"])


def teacher_forcing(eng, cfg, prompts, n_new, vision=None):
    """Generated tokens, the decode logits of every step, and the logits of
    one teacher-forced forward over prompt + generated tokens at the same
    positions (the model is causal, so position Sp-1+t sees exactly what
    decode step t saw)."""
    Sp = prompts.shape[1]
    gen = eng.generate(prompts, new_tokens=n_new, vision_embeds=vision)
    extra = {} if vision is None else {
        "vision_embeds": torch.from_numpy(vision)}
    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).long()
        logits, cache = eng.prefill(eng.params, {"tokens": tokens, **extra})
        cache = eng._grow_cache(cache)
        steps = [logits[:, -1]]
        for t in range(n_new - 1):
            tok = torch.from_numpy(gen[:, t:t + 1]).long()
            logits, cache = M.decode_step(eng.params, cfg, tok, cache, Sp + t)
            steps.append(logits[:, -1])
        seq = torch.from_numpy(np.concatenate([prompts, gen[:, :-1]], 1))
        full, _ = M.forward(eng.params, cfg, {"tokens": seq.long(), **extra},
                            q_chunk=MAX_SEQ, kv_chunk=MAX_SEQ)
    return gen, torch.stack(steps, 1), full[:, Sp - 1:]


def no_drop(cfg):
    """An moe config with capacity for every assignment (C >= S): capacity
    dispatch is not causal (in a forward over S tokens a hot expert drops
    the latest positions, while a decode step of one token never drops),
    so decode agrees with a teacher-forced forward only where nothing
    drops. Other families are returned as they are."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


def _decode_vs_forward(name):
    cfg = no_drop(reduce_for_smoke(get_config(name)))
    params = M.init_params(cfg, 3, device="cpu")
    if cfg.family == "vlm":
        params = open_gates(params, torch.ones_like)
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=BATCH,
                                               max_seq=MAX_SEQ,
                                               max_new_tokens=NEW))
    prompts = _prompts(cfg)
    gen, dec, full = teacher_forcing(eng, cfg, prompts, NEW, _vision(cfg))
    np.testing.assert_array_equal(dec.argmax(-1).numpy(), gen)
    diff = float((dec - full).abs().max())
    assert diff < 3e-2
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * diff
    same = full.argmax(-1).numpy() == gen
    assert same[clear.numpy()].all()
    return float(clear.float().mean())


@pytest.mark.parametrize("name", CONFIGS[:4])
def test_decode_agrees_with_teacher_forced_forward(name):
    """Decode (recurrent Mamba2 step with a bf16 state, softmax over the
    cache) and the full forward (chunked scan, flash) round at other
    points, so logits agree to ~1e-2 (measured up to 1.4e-2), and a greedy
    token may differ only where the forward's top-1/top-2 margin is within
    twice the measured difference."""
    assert _decode_vs_forward(name) > 0.5


@pytest.mark.parametrize("name", CONFIGS[4:])
def test_moe_and_vlm_decode_agree_with_teacher_forced_forward(name):
    """As above, for moe at no-drop capacity (`no_drop`) and vlm with its
    gates open (measured 1.1e-2 to 1.3e-2). At least half the positions
    have a clear margin, so the token check compares something
    (deepseek-moe-16b's smoke model: exactly half, 6 of 12)."""
    assert _decode_vs_forward(name) >= 0.5


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20",
                       "--new-tokens", "3", "--max-seq", "32"])
    assert toks.shape == (2, 3)
    out = capsys.readouterr().out
    assert "req0:" in out and "req1:" in out


def test_serve_launcher_restores_params_from_ckpt_dir(tmp_path, capsys):
    """`--ckpt-dir` restores {"params": ...} through the port's
    CheckpointManager, as the JAX package's launcher does: an empty
    directory leaves the seeded params, a checkpoint of other params
    serves those."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import serve
    args = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
            "--max-seq", "16"]
    seeded = serve.main(args)
    empty = serve.main(args + ["--ckpt-dir", str(tmp_path / "none")])
    assert np.array_equal(seeded, empty)
    assert "restored" not in capsys.readouterr().out
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    other = M.init_params(cfg, 5, device="cpu")
    with CheckpointManager(tmp_path / "ck", every=1,
                           async_write=False) as mgr:
        mgr.save({"params": other}, 3)
    restored = serve.main(args + ["--ckpt-dir", str(tmp_path / "ck")])
    assert "restored checkpoint step 3" in capsys.readouterr().out
    eng = ServeEngine(cfg, other, ServeConfig(max_batch=2, max_seq=16,
                                              max_new_tokens=4))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    assert np.array_equal(restored, eng.generate(prompts, new_tokens=4))
    assert not np.array_equal(restored, seeded)


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


def test_engine_casts_the_experts_once_and_keeps_router_and_gates():
    cfg = reduce_for_smoke(get_config("deepseek-moe-16b"))
    params = M.init_params(cfg, 0, device="cpu")
    eng = ServeEngine(cfg, params, ServeConfig())
    layer, src = eng.params["stack"]["layers"][0], params["stack"]["layers"][0]
    for name in ("gate", "up", "down"):
        assert layer["moe"]["experts"][name].dtype == torch.bfloat16
        assert layer["moe"]["shared"][name]["w"].dtype == torch.bfloat16
    assert layer["moe"]["router"] is src["moe"]["router"]
    assert layer["moe"]["router"].dtype == torch.float32
    assert eng.params["stack"]["first"][0]["ffn"]["up"]["w"].dtype == \
        torch.bfloat16
    vcfg = reduce_for_smoke(get_config("llama-3.2-vision-90b"))
    vparams = M.init_params(vcfg, 0, device="cpu")
    cross = ServeEngine(vcfg, vparams, ServeConfig()).params["stack"][
        "cross"][0]
    assert cross["attn_gate"] is vparams["stack"]["cross"][0]["attn_gate"]
    assert cross["cross_attn"]["wq"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(set(
    CONFIGS + ["musicgen-large", "phi3-mini-3.8b", "smollm-360m"])))
def test_cache_batch_on_every_family(name):
    cfg = reduce_for_smoke(get_config(name))
    # batch 3 differs from every leading axis of the smoke caches (L, U, I)
    assert cache_batch(M.init_decode_cache(cfg, 3, 8, device="cpu")) == 3


def test_engine_grows_a_prefill_cache_of_any_batch():
    for name in ("zamba2-2.7b", "deepseek-moe-16b", "llama-3.2-vision-90b"):
        cfg = reduce_for_smoke(get_config(name))
        params = M.init_params(cfg, 0, device="cpu")
        if cfg.family == "vlm":
            params = open_gates(params, torch.ones_like)
        eng = ServeEngine(cfg, params, ServeConfig(max_batch=3, max_seq=24))
        vision = None
        if cfg.family == "vlm":
            vision = np.random.default_rng(2).normal(
                size=(3, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        got = eng.generate(np.zeros((3, 8), np.int32), new_tokens=3,
                           vision_embeds=vision)
        assert got.shape == (3, 3)


def test_engine_wants_vision_embeds_for_a_vlm_only():
    vcfg = reduce_for_smoke(get_config("llama-3.2-vision-90b"))
    eng = ServeEngine(vcfg, M.init_params(vcfg, 0, device="cpu"),
                      ServeConfig(max_batch=1, max_seq=16))
    with pytest.raises(ValueError, match="vision_embeds"):
        eng.generate(np.zeros((1, 4), np.int32), new_tokens=2)
    cfg = reduce_for_smoke(get_config("qwen3-4b"))
    eng = ServeEngine(cfg, M.init_params(cfg, 0, device="cpu"),
                      ServeConfig(max_batch=1, max_seq=16))
    with pytest.raises(ValueError, match="vision_embeds"):
        eng.generate(np.zeros((1, 4), np.int32), new_tokens=2,
                     vision_embeds=np.zeros((1, 16, cfg.d_model)))


def test_serve_launcher_refuses_a_vlm_and_serves_moe_on_the_cpu():
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="vision"):
        serve.main(["--arch", "llama-3.2-vision-90b", "--smoke",
                    "--device", "cpu"])
    toks = serve.main(["--arch", "deepseek-moe-16b", "--smoke", "--device",
                       "cpu", "--batch", "1", "--prompt-len", "8",
                       "--new-tokens", "2", "--max-seq", "16"])
    assert toks.shape == (1, 2)
