"""The port's train step and trainer (`train/step.py`, `train/trainer.py`)
against the JAX package's, on the CPU: one step from the same converted
state for the dense, ssm and hybrid families, gradient accumulation
(`tests/test_extensions.py::test_microbatch_equals_full_batch`), and the
trainer cases of `tests/test_train_serve.py` (loss decreases,
crash-resume, gradient compression) with the port's checkpoints. The
trainer cases use the manager without its writer thread
(`async_write=False`) unless a case is about it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduce_for_smoke as jreduce
from repro.ckpt.checkpoint import flatten_state as jflatten
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.state import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch.ckpt.checkpoint import Stacked, flatten_state
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import tree_leaves
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_eval_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_np(tree) -> dict:
    out = {}
    for name, v in flatten_state(tree).items():
        t = torch.stack(v.parts).reshape(v.shape) if isinstance(v, Stacked) \
            else v
        out[name] = t.detach().float().numpy()
    return out


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_train_step_matches_jax(arch):
    """One step at step 3 (lr > 0 after warmup starts) from the JAX
    package's converted state, on the same batch. Loss within 1e-3 and
    grad norm within 2e-3 relative (bf16 rounding and XLA's sum orders);
    lr exact to float32; m and v, which carry the clipped gradient, within
    6 % (relative norm over all leaves); the params: a first Adam step
    moves each by lr * (0.56 sign(g) + wd p) at step 3, so a gradient
    whose sign flips between the packages moves it by up to 1.12 lr the
    other way: the mean change within 0.05 lr, the largest within
    1.2 lr."""
    jcfg, cfg = jreduce(jget_config(arch)), reduce_for_smoke(get_config(arch))
    js = jinit_train_state(jcfg, jax.random.PRNGKey(0))
    js["step"] = jnp.asarray(3, jnp.int32)
    b = JSyntheticTokens(jcfg.padded_vocab, 32, 4).batch_at(0)
    hp = dict(lr=1e-3, warmup_steps=5, total_steps=20)
    kw = dict(q_chunk=16, kv_chunk=16, ssd_chunk=16)
    jns, jm = jax.jit(jmake_train_step(jcfg, JAdamWConfig(**hp), **kw))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    ts = init_train_state(cfg, device="cpu", params=params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js["params"]),
        device="cpu"))
    ts["step"].fill_(3)
    ts, tm = make_train_step(cfg, AdamWConfig(**hp), **kw)(
        ts, {k: torch.from_numpy(v) for k, v in b.items()})
    assert int(ts["step"]) == int(jns["step"]) == 4
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-3
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    lr = float(jm["lr"])
    for key in ("m", "v"):
        want = {k: np.asarray(v, np.float32)
                for k, v in jflatten(jns["opt"][key]).items()}
        got = _flat_np(ts["opt"][key])
        assert sorted(got) == sorted(want)
        num = sum(np.sum((got[k] - want[k]) ** 2) for k in want)
        den = sum(np.sum(want[k] ** 2) for k in want)
        assert np.sqrt(num / den) < 6e-2, key
    want = {k: np.asarray(v, np.float32)
            for k, v in jflatten(jns["params"]).items()}
    got = _flat_np(ts["params"])
    d = np.concatenate([(got[k] - want[k]).ravel() for k in want])
    assert np.abs(d).mean() < 0.05 * lr
    assert np.abs(d).max() < 1.2 * lr


def test_microbatch_equals_full_batch():
    """Gradient accumulation over 4 microbatches against one full batch,
    from step 0 as the JAX package's test (lr 0 there: the params stay
    put, held to its tolerances, rtol 2e-2 / atol 3e-4, and the loss to
    1e-3). The accumulated gradient, which the first moment m carries, is
    held too: within 2 % of the full batch's (relative norm; bf16 sums of
    quarter batches)."""
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    hp = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    kw = dict(q_chunk=16, kv_chunk=16, ssd_chunk=16)
    s1 = init_train_state(cfg, device="cpu")
    s2 = init_train_state(cfg, device="cpu")
    o1, m1 = make_train_step(cfg, hp, **kw)(s1, batch)
    o2, m2 = make_train_step(cfg, hp, microbatches=4, **kw)(s2, batch)
    for a, b in zip(tree_leaves(o1["params"]), tree_leaves(o2["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=3e-4)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    assert float(m1["lr"]) == float(m2["lr"])
    assert int(o1["step"]) == int(o2["step"]) == 1
    num = den = 0.0
    for a, b in zip(tree_leaves(o1["opt"]["m"]), tree_leaves(o2["opt"]["m"])):
        num += float(torch.sum((a - b) ** 2))
        den += float(torch.sum(a ** 2))
    assert den > 0 and (num / den) ** 0.5 < 2e-2


def test_weight_decay_follows_the_jax_layouts_rank():
    """A layer's norm scale is [d] in the port and one row of [L, d] in
    the JAX package, which decays it; the final norm's [d] is not
    decayed in either."""
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import jax_ndims
    params = {"final_norm": {"scale": torch.ones(4)},
              "stack": {"layers": [{"s": torch.ones(4)},
                                   {"s": torch.ones(4)}],
                        "units": [[{"s": torch.ones(4)}]]}}
    assert jax_ndims(params) == [1, 2, 2, 3]
    grads = {"final_norm": {"scale": torch.zeros(4)},
             "stack": {"layers": [{"s": torch.zeros(4)},
                                  {"s": torch.zeros(4)}],
                       "units": [[{"s": torch.zeros(4)}]]}}
    opt = adamw.init_opt_state(params)
    adamw.adamw_update(params, grads, opt, torch.tensor(5),
                       adamw.AdamWConfig(lr=1.0, warmup_steps=0,
                                         weight_decay=0.1))
    assert float(params["final_norm"]["scale"][0]) == 1.0
    for t in (params["stack"]["layers"][1]["s"],
              params["stack"]["units"][0][0]["s"]):
        assert float(t[0]) < 1.0


def test_eval_step_is_the_loss_without_remat():
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    st = init_train_state(cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in
         JSyntheticTokens(cfg.padded_vocab, 16, 2).batch_at(1).items()}
    m = make_eval_step(cfg, q_chunk=16, kv_chunk=16)(st["params"], b)
    _, tm = make_train_step(cfg, AdamWConfig(), q_chunk=16, kv_chunk=16)(
        init_train_state(cfg, device="cpu"), b)
    assert float(m["loss"]) == float(tm["loss"])
    assert m["loss"].grad_fn is None


def _mk(tmp, steps=12, ckpt_every=4, **kw):
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    tcfg = TrainerConfig(steps=steps, log_every=1, ckpt_every=ckpt_every,
                         seq_len=64, global_batch=4)
    hp = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    return cfg, Trainer(cfg, tcfg, hp, tmp, device="cpu",
                        async_write=kw.pop("async_write", False), **kw)


def test_loss_decreases(tmpdir_path):
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    tcfg = TrainerConfig(steps=30, log_every=1, ckpt_every=1000,
                         seq_len=64, global_batch=8)
    hp = AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=30)
    out = Trainer(cfg, tcfg, hp, tmpdir_path / "c", device="cpu",
                  async_write=False).run()
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] - 0.05, losses[:3] + losses[-3:]


@pytest.mark.parametrize("device_compress,async_write",
                         [(False, False), (True, True)])
def test_crash_resume_bitexact(tmpdir_path, device_compress, async_write):
    """An interrupted-then-resumed run ends at the same losses and state
    as a straight run, bit for bit (the JAX package's test holds the
    params to 1e-5; the port holds every leaf, moments and step included,
    exactly), with the serial manager and with the writer thread and the
    device codec path."""
    kw = dict(device_compress=device_compress, async_write=async_write)
    _, straight = _mk(tmpdir_path / "a", **kw)
    out_straight = straight.run()
    _, tr1 = _mk(tmpdir_path / "b", **kw)
    with pytest.raises(RuntimeError, match="injected crash at step 6"):
        tr1.run(crash_at=6)
    _, tr2 = _mk(tmpdir_path / "b", **kw)
    out_resumed = tr2.run()
    assert out_resumed["history"][0]["step"] == 5
    want = {h["step"]: h["loss"] for h in out_straight["history"]}
    for h in out_resumed["history"]:
        assert h["loss"] == want[h["step"]]
    a, b = flatten_state(out_straight["state"]), flatten_state(
        out_resumed["state"])
    assert list(a) == list(b)
    for name, x in a.items():
        xs = x.parts if isinstance(x, Stacked) else [x]
        ys = b[name].parts if isinstance(b[name], Stacked) else [b[name]]
        for u, w in zip(xs, ys):
            assert torch.equal(u, w), name


def test_grad_compression_trains(tmpdir_path):
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    tcfg = TrainerConfig(steps=10, log_every=1, ckpt_every=1000, seq_len=32,
                         global_batch=4, grad_compression=True)
    hp = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    out = Trainer(cfg, tcfg, hp, tmpdir_path / "c", device="cpu",
                  async_write=False).run()
    assert "residuals" in out["state"]
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all()
    res = tree_leaves(out["state"]["residuals"])
    assert any(bool(r.abs().sum() > 0) for r in res)


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-90b",
                                  "qwen3-4b"])
def test_trainer_batches_equal_jax(arch, tmpdir_path):
    """The trainer's batch of a step, by family (tokens; seeded embeddings
    for audio; seeded vision embeddings for vlm), equals the JAX
    trainer's."""
    jcfg, cfg = jreduce(jget_config(arch)), reduce_for_smoke(get_config(arch))
    tc = dict(steps=2, seq_len=16, global_batch=2)
    jt = JTrainer.__new__(JTrainer)
    jt.cfg = jcfg
    jt.data = JSyntheticTokens(jcfg.padded_vocab if jcfg.family != "audio"
                               else jcfg.vocab_size, 16, 2, seed=0)
    pt = Trainer(cfg, TrainerConfig(**tc), AdamWConfig(), tmpdir_path,
                 device="cpu", async_write=False)
    for step in (0, 3):
        a, b = pt._make_batch(step), JTrainer._make_batch(jt, step)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_train_launcher_runs_on_the_cpu(tmpdir_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "smollm-360m", "--smoke", "--steps", "6",
                      "--seq", "32", "--batch", "2", "--ckpt-every", "3",
                      "--ckpt-dir", str(tmpdir_path), "--device", "cpu"])
    assert int(out["state"]["step"]) == 6
    assert "done: loss" in capsys.readouterr().out
    assert (tmpdir_path / "step_00000006.bp4").exists()


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu", "--steps", "8"])
    text = capsys.readouterr().out
    assert "injected crash at step 5" in text
    assert "resumed from checkpoint step 4" in text
    assert int(out["state"]["step"]) == 8
