"""The port's forward and train step over a (2, 2) ("data", "model") mesh
of 4 gloo ranks on the CPU (one module-scoped `RankPool`), against two
references from the same numpy-seeded params and batch: the port's
single-device step, and the JAX package's `make_train_step` jitted on 4
host devices under `use_mesh` with `train_state_shardings` of a concrete
`compat_make_mesh((2, 2), ("data", "model"))` (a subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=4`, started when the
module's first test asks for it and running beside the ranks). The
dense, hybrid and moe families at smoke width; smollm with 3 q-heads
over 1 kv head pads its q-heads to 4 on `model` = 2 and runs with
`microbatches=2` and `grad_compression=True`.

Tolerance (that of `tests/test_torch_train.py::
test_loss_and_grads_match_jax_value_and_grad` for the single-device
parity): bf16 rounds at the same points, but sums run in other orders
(XLA's, and the mesh's partial sums). Loss within 1e-3, aux within 1e-2
relative; all gradients together within 6 % (relative norm) and each
leaf within 25 %, read after the step from the grad norm and the
moments, which at step 3 from zero moments are m = (1 - b1) c g and
sqrt(v) = sqrt(1 - b2) c |g| (c the clip scale); lr exact to float32;
the params, which a first Adam step moves by about
lr * (0.56 sign(g) + wd p), so a sign flip of a tiny gradient moves one
by up to 1.12 lr the other way: the mean change within 0.05 lr, the
largest within 1.2 lr (the step parity of `tests/test_torch_trainer.py`).
The mesh is held to that against the one device. A moe token near a
routing tie picks another expert on another sum order (another expert,
a gradient elsewhere), so the moe case records each MoE call's top-k
experts on the one device, the forward's and remat's recompute's, and
replays them on the mesh (`_routes`; the weights are the mesh's own
probabilities at those experts); the mesh's own top-k experts equal the
one device's on every token whose k-th probability clears the next by
more than 2e-2. Against the JAX side, which routes freely, where the two
references are further apart than the tolerance, each number is held to
twice their distance instead (the noise floor, as the train step's noise
floor on the card is 2); for the dense and hybrid cases the references
must agree within the tolerance themselves.

A forward under `meshctx.recording_hints` checks that each hinted
activation's placements are `to_placements` of the reference's spec at
that site, the spec built from the JAX package's own `_attn_axes` and
`_ssm_head_axis` on the same mesh. No JAX in this process: the rank
processes import this module."""
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import meshctx
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as S
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import tree_map
from repro_torch.train.state import init_train_state, train_state_shardings
from repro_torch.train.step import make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
BATCH = ("pod", "data")
HP = dict(lr=1e-3, warmup_steps=5, total_steps=20)
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssd_chunk=16)
#: name -> (arch, config overrides, step options)
CASES = {
    "dense": ("smollm-360m", {}, {}),
    "dense_padded_mb_int8": ("smollm-360m",
                             {"n_heads": 3, "n_kv_heads": 1, "head_dim": 32},
                             {"microbatches": 2, "grad_compression": True}),
    "hybrid": ("zamba2-2.7b", {}, {}),
    "moe": ("deepseek-moe-16b", {}, {}),
}


def _cfg(case):
    arch, over, _ = CASES[case]
    return dataclasses.replace(reduce_for_smoke(get_config(arch)), **over)


def _np_params(cfg, seed=0) -> dict:
    """Params made with numpy, under the JAX package's flat names (stacked
    layers as one array), with the JAX package's init scales: normal
    draws over sqrt(fan-in) (`_scale`), norm scales and D at 1, biases at
    0, the Mamba2 A_log and dt_bias constants."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, leaf in ckpt.flatten_state(M.param_shapes(cfg)).items():
        shape = tuple(leaf.shape)
        last = name.rsplit("/", 1)[-1]
        if last in ("scale", "D"):
            a = np.ones(shape, np.float32)
        elif last in ("A_log", "dt_bias"):
            H = shape[-1]
            row = (np.log(np.linspace(1.0, 16.0, H)) if last == "A_log" else
                   np.log(np.expm1(np.geomspace(1e-3, 1e-1, H))))
            a = np.broadcast_to(row.astype(np.float32), shape).copy()
        elif last == "b":
            a = np.zeros(shape, np.float32)
        else:
            a = rng.standard_normal(shape) * _scale(name, shape)
            a = a.astype(np.float32)
        out[name] = a
    return out


def _scale(name: str, shape) -> float:
    """The init scale of a weight: 0.02 for an embedding table, else one
    over sqrt(fan-in): d_model for the [d, H, hd] q/k/v projections,
    H * hd for the [H, hd, d] output, the next-to-last dim otherwise."""
    if name.endswith("table"):
        return 0.02
    if name.endswith(("wq/w", "wk/w", "wv/w")):
        return 1 / np.sqrt(shape[-3])
    if name.endswith("wo/w"):
        return 1 / np.sqrt(shape[-3] * shape[-2])
    return 1 / np.sqrt(shape[-2]) if len(shape) >= 2 else 1.0


def _np_batch(cfg, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
            for k in ("tokens", "labels")}


def _nest(flat: dict) -> dict:
    """Flat "a/b/c" names -> nested dicts (the JAX package's tree)."""
    out: dict = {}
    for name, v in flat.items():
        *path, last = name.split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _state(case, d) -> dict:
    """The case's port train state at step 3, on the CPU."""
    cfg = _cfg(case)
    flat = dict(np.load(d / f"{case}.params.npz"))
    gc = CASES[case][2].get("grad_compression", False)
    st = init_train_state(cfg, device="cpu", grad_compression=gc,
                          params=params_from_numpy(cfg, _nest(flat),
                                                   device="cpu"))
    st["step"].fill_(3)
    return st


def _flat_np(tree, prefix) -> dict:
    out = {}
    for name, v in ckpt.flatten_state(tree).items():
        t = torch.stack(v.parts).reshape(v.shape) \
            if isinstance(v, ckpt.Stacked) else v
        if meshctx.is_dtensor(t):
            t = t.full_tensor()
        out[f"{prefix}/{name}"] = t.detach().float().numpy()
    return out


def _step(case, state, batch):
    cfg = _cfg(case)
    fn = make_train_step(cfg, AdamWConfig(**HP), **CHUNKS, **CASES[case][2])
    state, m = fn(state, batch)
    out = {**_flat_np(state["params"], "params"),
           **_flat_np(state["opt"]["m"], "opt/m"),
           **_flat_np(state["opt"]["v"], "opt/v")}
    return out, {k: float(v) for k, v in m.items()}


class _routes:
    """`moe.route` recording each call's top-k experts [B,S,k] and the
    margin of its k-th probability over the next [B,S] (`path` None:
    returned by `calls` and `margins`), or replaying those saved at `path`
    on the rank's batch rows (over `data`), with the weights renormalised
    from the call's own probabilities at those experts (their gradient
    reaches the router as the top-k's does); `calls` then holds the
    experts the rank's own top-k chose. A remat'd step's recompute calls
    `route` again: it records, and replays, those calls too, in order."""

    def __init__(self, path=None, rows=None):
        self.path, self.rows, self.calls, self.margins = path, rows, [], []

    def __enter__(self):
        from repro_torch.models import moe
        self.saved = real = moe.route
        replay = (None if self.path is None else
                  iter(np.load(self.path)["routes"]))

        def route(p, x, cfg):
            probs, top_w, top_e = real(p, x, cfg)
            self.calls.append(top_e.numpy())
            if replay is None:
                top = torch.sort(probs.detach(), dim=-1,
                                 descending=True).values
                self.margins.append(
                    (top[..., cfg.top_k - 1] - top[..., cfg.top_k]).numpy())
                return probs, top_w, top_e
            top_e = torch.from_numpy(
                next(replay)[self.rows, :x.shape[1]]).to(top_e)
            top_w = torch.gather(probs, -1, top_e)
            top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True),
                                            1e-9)
            return probs, top_w, top_e
        moe.route = route
        return self

    def __exit__(self, *a):
        from repro_torch.models import moe
        moe.route = self.saved
        return False

    def save(self, path):
        """The recorded calls as one [calls, B, S, k] array, each padded to
        the longest S (a prefill's; a decode call's S is 1)."""
        s = max(c.shape[1] for c in self.calls)
        np.savez(path, routes=np.stack([
            np.pad(c, ((0, 0), (0, s - c.shape[1]), (0, 0)))
            for c in self.calls]))



# ------------------------------------------------------------- rank tasks
def _rank_step(case, d):
    """The case's step on the (2, 2) mesh: rank 0's result (the whole
    state after it (numpy), the metrics, the params' placements and the
    microbatches'; None on the other ranks), and where the routes are
    replayed, the rank's first batch row and the experts its own top-k
    chose at each MoE call."""
    d = pathlib.Path(d)
    mesh = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    gc = CASES[case][2].get("grad_compression", False)
    state = _state(case, d)
    sh = train_state_shardings(_cfg(case), mesh, grad_compression=gc)
    from torch.distributed.tensor import distribute_tensor
    state = tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements),
                     state, sh)
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(d / f"{case}.batch.npz").items()}
    routes = d / f"{case}.routes.npz"
    rows, own = slice(None), None
    if routes.exists():
        n = len(batch["tokens"]) // mesh.size(0)
        at = mesh.get_local_rank(0) * n
        rows = slice(at, at + n)
    with meshctx.recording_hints() as rec, \
            (_routes(routes, rows) if routes.exists() else
             contextlib.nullcontext()) as replay:
        out, m = _step(case, state, batch)
    if replay is not None:
        own = (rows.start, replay.calls)
    placements = sorted({str(tuple(t.placements)) for t in
                         ckpt.flatten_state(state["params"]).values()
                         if not isinstance(t, ckpt.Stacked)})
    micro = sorted({tuple(str(p) for p in pl) for site, pl in rec
                    if site == "step.microbatch"})
    return ((out, m, placements, micro)
            if torch.distributed.get_rank() == 0 else None), own


def _rank_hints(case, d):
    """Every labelled hint and `local_map` placement of one forward (and,
    for the hybrid family, of a Mamba2 block with an initial state)."""
    from torch.distributed.tensor import distribute_tensor
    d = pathlib.Path(d)
    cfg = _cfg(case)
    mesh = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    state = _state(case, d)
    sh = train_state_shardings(cfg, mesh)
    params = tree_map(lambda t, s: distribute_tensor(t, s.mesh,
                                                     s.placements),
                      state["params"], sh["params"])
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(d / f"{case}.batch.npz").items()}
    from repro_torch.train.state import shard_batch
    batch = shard_batch(batch, mesh)
    with meshctx.recording_hints() as rec, meshctx.dtensor_scope(mesh):
        M.forward(params, cfg, batch, remat=False, **CHUNKS)
        if cfg.family == "hybrid":
            from repro_torch.models import ssm
            layer = params["stack"]["units"][0][0]["mamba"]
            H, P, N = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state
            u = distribute_tensor(torch.ones(4, 16, cfg.d_model),
                                  mesh, meshctx.placements(
                                      (4, 16, cfg.d_model), BATCH, None,
                                      None, mesh=mesh))
            h0 = distribute_tensor(torch.zeros(4, H, P, N), mesh,
                                   meshctx.placements((4, H, P, N), BATCH,
                                                      None, None, None,
                                                      mesh=mesh))
            ssm.mamba2_seq(layer, u, cfg=cfg, initial_state=h0, chunk=16)
    return [(site, [str(p) for p in pl]) for site, pl in rec]


# ------------------------------------------------------------------ the JAX side
_JAX_SIDE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.ckpt.checkpoint import flatten_state
from repro.configs.base import get_config, reduce_for_smoke
from repro.launch.mesh import compat_make_mesh
from repro.launch.sharding import batch_sharding_for
from repro.meshctx import use_mesh
from repro.models.attention import _attn_axes
from repro.models.ssm import _ssm_head_axis
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.optim.grad_compress import init_residuals
from repro.train.state import train_state_shardings
from repro.train.step import make_train_step

d, cases, hp, chunks = json.loads(sys.argv[1])
mesh = compat_make_mesh((2, 2), ("data", "model"))


def nest(flat):
    out = {}
    for name, v in flat.items():
        *path, last = name.split("/")
        t = out
        for k in path:
            t = t.setdefault(k, {})
        t[last] = jnp.asarray(v)
    return out


for case, (arch, over, opts) in cases.items():
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **over)
    gc = opts.get("grad_compression", False)
    params = nest(dict(np.load(f"{d}/{case}.params.npz")))
    state = {"params": params, "opt": init_opt_state(params),
             "step": jnp.asarray(3, jnp.int32)}
    if gc:
        state["residuals"] = init_residuals(params)
    sh = train_state_shardings(cfg, mesh, grad_compression=gc)
    state = jax.device_put(state, sh)
    batch = {k: jnp.asarray(v) for k, v in
             np.load(f"{d}/{case}.batch.npz").items()}
    bsh = {k: batch_sharding_for(mesh, v) for k, v in batch.items()}
    batch = jax.device_put(batch, bsh)
    with use_mesh(mesh):
        step = jax.jit(make_train_step(cfg, AdamWConfig(**hp), **chunks,
                                       **opts),
                       in_shardings=(sh, bsh), out_shardings=(sh, None))
        new, m = step(state, batch)
        axes = {"attn": [list(a) for a in _attn_axes(cfg)],
                "ssm": (_ssm_head_axis(cfg.n_ssm_heads)
                        if cfg.n_ssm_heads else None)}
    out = {}
    for key in ("params", "opt"):
        for name, v in flatten_state(new[key]).items():
            out[f"{key}/{name}"] = np.asarray(v, np.float32)
    np.savez(f"{d}/{case}.jax.npz", **out)
    with open(f"{d}/{case}.jax.json", "w") as f:
        json.dump({"metrics": {k: float(v) for k, v in m.items()},
                   "axes": axes}, f)
print("done")
"""


class _JaxRun:
    """The JAX side, running in the background from the module's first
    use."""

    def __init__(self, d):
        self.d = d
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   JAX_PLATFORMS="cpu")
        arg = json.dumps([str(d), CASES, HP, CHUNKS])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_SIDE, arg], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._done = None

    def result(self, case) -> tuple[dict, dict]:
        if self._done is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-4000:]
            self._done = True
        npz = dict(np.load(self.d / f"{case}.jax.npz"))
        doc = json.loads((self.d / f"{case}.jax.json").read_text())
        return npz, doc

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


# ------------------------------------------------------------------ tests
@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The numpy params and batch of every case, and the JAX side started
    on them."""
    d = tmp_path_factory.mktemp("mesh_step")
    for case in CASES:
        cfg = _cfg(case)
        np.savez(d / f"{case}.params.npz", **_np_params(cfg))
        np.savez(d / f"{case}.batch.npz", **_np_batch(cfg))
    run = _JaxRun(d)
    yield d, run
    run.close()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with D.RankPool(4, tmp_path_factory.mktemp("store"), timeout=300) as p:
        yield p


#: the stated tolerance of each of `_errors`' numbers
TOL = {"loss": 1e-3, "aux": 1e-2, "grad_norm": 6e-2, "m_leaf": 0.25,
       "m_all": 6e-2, "sqrt_v_leaf": 0.25, "sqrt_v_all": 6e-2,
       "params_mean_lr": 0.05, "params_max_lr": 1.2}


def _errors(got, gm, want, wm) -> dict:
    """How far `got` (a state after the step, flat numpy) and its metrics
    are from `want` and `wm`, in the units of `TOL`."""
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(gm["lr"], wm["lr"], rtol=1e-7)
    out = {"loss": abs(gm["loss"] - wm["loss"]),
           "aux": abs(gm["aux"] - wm["aux"]) / max(abs(wm["aux"]), 1e-7),
           "grad_norm": abs(gm["grad_norm"] - wm["grad_norm"])
           / wm["grad_norm"]}
    for key, f in (("m", lambda a: a), ("sqrt_v", np.sqrt)):
        names = [k for k in want if k.startswith(f"opt/{key[-1]}/")]
        num = den = leaf = 0.0
        for k in names:
            err = np.linalg.norm(f(got[k]) - f(want[k]))
            ref = np.linalg.norm(f(want[k]))
            leaf = max(leaf, err / max(ref, 1e-30))
            num, den = num + err ** 2, den + ref ** 2
        out[f"{key}_leaf"], out[f"{key}_all"] = leaf, np.sqrt(num / den)
    d = np.concatenate([(got[k] - want[k]).ravel() for k in want
                        if k.startswith("params/")])
    out["params_mean_lr"] = np.abs(d).mean() / wm["lr"]
    out["params_max_lr"] = np.abs(d).max() / wm["lr"]
    return out


def _check(errors: dict, floor: dict):
    """Each number within its tolerance, or within twice the two
    references' own distance (the noise floor) where that is larger."""
    for k, tol in TOL.items():
        bound = max(tol, 2.0 * floor[k])
        assert errors[k] <= bound, (k, errors[k], tol, floor[k])


@pytest.mark.parametrize("case", list(CASES))
def test_step_on_2x2_matches_the_single_device_and_jax_steps(pool, inputs,
                                                             case):
    d, jax_run = inputs
    moe = _cfg(case).family == "moe"
    with (_routes() if moe else contextlib.nullcontext()) as rec:
        one, om = _step(case, _state(case, d), {
            k: torch.from_numpy(v) for k, v in
            np.load(d / f"{case}.batch.npz").items()})
    if moe:
        rec.save(d / f"{case}.routes.npz")
    ranks = pool.run(_rank_step, case, str(d))
    got, gm, placements, micro = ranks[0][0]
    # the state really was laid out over both axes
    assert any("Shard" in p for p in placements)
    if CASES[case][2].get("microbatches", 1) > 1:
        # each microbatch pinned to the batch axes (step.py:48-50)
        want_pl = tuple(str(p) for p in S.to_placements(
            S.P("data"), tmesh.AbstractMesh((2, 2), AXES)))
        assert micro == [want_pl]
    want, doc = jax_run.result(case)
    wm = doc["metrics"]
    floor = _errors(one, om, want, wm)
    # the mesh and the one device share their routes (moe) or have none:
    # the mesh is held to the tolerance itself against the one device
    _check(_errors(got, gm, one, om), {k: 0.0 for k in TOL})
    _check(_errors(got, gm, want, wm), floor)
    if moe:
        # the mesh's own routing: its top-k experts (as a set) equal the
        # one device's on every token whose k-th probability clears the
        # next by more than 2e-2, in the forward and in remat's recompute
        clear = 0
        for at, calls in (own for _, own in ranks):
            assert len(calls) == len(rec.calls)
            for mine, one_e, margin in zip(calls, rec.calls, rec.margins):
                rows = slice(at, at + mine.shape[0])
                ok = margin[rows] > 2e-2
                assert (np.sort(mine, -1)[ok]
                        == np.sort(one_e[rows], -1)[ok]).all()
                clear += int(ok.sum())
        assert clear > 0
    else:
        # no routing: the references agree within the tolerance themselves
        _check(floor, {k: 0.0 for k in TOL})
    assert all(np.isfinite(v).all() for v in got.values())


def _expected(case, axes) -> dict:
    """The reference's spec at each hint site the port labels, from the
    JAX package's `_attn_axes` and `_ssm_head_axis` on the (2, 2) mesh
    (JAX's file:line beside each)."""
    cfg = _cfg(case)
    (qh, qd), (kh, kd) = axes["attn"]
    heads = (BATCH, None, "model", None)
    want = {"model.embed": (BATCH, None, None),              # model.py:71
            "attn.q": (BATCH, None, qh, qd),                 # attention.py:92
            "attn.k": (BATCH, None, kh, kd),                 # :93
            "attn.v": (BATCH, None, kh, kd),                 # :94
            "attn.flash_in.q": heads,                        # :296
            "attn.flash_in.k": heads,                        # :297
            "attn.flash_in.v": heads,                        # :298
            # the flash core's chunked q/k/v (:117-119), in [B,S,H,D]
            "attn.flash.in0": heads, "attn.flash.in1": heads,
            "attn.flash.in2": heads, "attn.flash.out0": heads}
    if cfg.family == "hybrid":
        h = axes["ssm"]
        want.update({"ssm.scan.in0": (BATCH, None, h, None),  # ssm.py:81
                     "ssm.scan.in1": (BATCH, None, h),        # :82
                     "ssm.scan.in6": (BATCH, h, None, None),  # :87
                     "ssm.scan.out1": (BATCH, h, None, None)})  # :110
    if cfg.family == "moe":
        want.update({"moe.buf": (BATCH, "model", None, None),  # moe.py:87
                     "moe.buf_experts": ("model", None, None),  # :93
                     "moe.hidden": ("model", None, "data"),     # :101
                     "moe.combine": (BATCH, None, None, None),  # :105
                     "moe.out": (BATCH, None, None)})           # :119
    return want


@pytest.mark.parametrize("case", ["dense_padded_mb_int8", "hybrid", "moe"])
def test_hinted_activations_are_laid_out_as_the_reference_hints_them(
        pool, inputs, case):
    d, jax_run = inputs
    _, doc = jax_run.result(case)
    want = _expected(case, doc["axes"])
    rec = pool.run(_rank_hints, case, str(d))
    mesh = tmesh.AbstractMesh((2, 2), AXES)
    for rank_rec in rec:
        seen = {}
        for site, pl in rank_rec:
            if site in want:
                seen.setdefault(site, set()).add(tuple(pl))
        assert sorted(seen) == sorted(want), sorted(set(want) - set(seen))
        for site, spec in want.items():
            filt = [tuple(a for a in (e if isinstance(e, tuple) else (e,))
                          if a in AXES) or None if e is not None else None
                    for e in spec]
            pl = tuple(str(p) for p in S.to_placements(S.P(*filt), mesh))
            assert seen[site] == {pl}, (site, seen[site], pl)
    if case == "dense_padded_mb_int8":
        # 3 q-heads do not divide 2: head_dim layout before the padding
        assert doc["axes"]["attn"] == [[None, "model"], [None, "model"]]


# -------------------------------------------- one-device mesh, in process
@pytest.fixture()
def cpu_mesh():
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = tmesh.make_mesh((1, 1), AXES, device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _replicated(mesh, *ts):
    from torch.distributed.tensor import DTensor, Replicate
    return [DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False) for t in ts]


def test_kernel_wrappers_refuse_a_dtensor_and_run_under_local_map(cpu_mesh):
    """A DTensor reaching flash, the SSD scan or a byte shuffle raises
    TypeError (no gather, no quiet `to_local`); through `local_map` each
    runs on the local tensors, here their plain versions, bit for bit the
    direct call."""
    from repro_torch.kernels.bitshuffle import ops as bops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 32, 2, 16, generator=g).bfloat16()
               for _ in range(3))
    dq, dk, dv = _replicated(cpu_mesh, q, k, v)
    for fn in (fops.flash_attention, fops.flash_forward):
        with pytest.raises(TypeError, match="DTensor"):
            fn(dq, dk, dv)
    spec = (BATCH, None, "model", None)
    got = meshctx.local_map(
        lambda a, b, c: fops.flash_forward(a, b, c, qc=16, kc=16),
        (dq, dk, dv), (spec,) * 3, (spec, (BATCH, "model", None)),
        ((2, 32, 2, 16), (2, 2, 32)), site="t")
    for a, b in zip(got, fops.flash_forward(q, k, v, qc=16, kc=16)):
        assert meshctx.is_dtensor(a) and torch.equal(a.to_local(), b)
    x = torch.randn(2, 32, 2, 8, generator=g)
    dt = torch.rand(2, 32, 2, generator=g) * 0.1
    A, D = -torch.linspace(1.0, 2.0, 2), torch.ones(2)
    B = torch.randn(2, 32, 4, generator=g)
    args = _replicated(cpu_mesh, x, dt, A, B, B, D)
    with pytest.raises(TypeError, match="DTensor"):
        sops.ssd_scan(*args, chunk=16)
    hs = (BATCH, None, "model", None)
    got = meshctx.local_map(
        lambda *a: sops.ssd_scan(*a, chunk=16), tuple(args),
        (hs, (BATCH, None, "model"), ("model",), (BATCH, None, None),
         (BATCH, None, None), ("model",)),
        (hs, (BATCH, "model", None, None)), ((2, 32, 2, 8), (2, 2, 8, 4)))
    for a, b in zip(got, sops.ssd_scan(x, dt, A, B, B, D, chunk=16)):
        assert torch.equal(a.to_local(), b)
    (raw,) = _replicated(cpu_mesh, torch.zeros(4096, dtype=torch.uint8))
    for fn, kw in ((bops.shuffle_blocks, {"block": 1024, "itemsize": 4}),
                   (bops.shuffle_block, {"itemsize": 4}),
                   (bops.shuffle, {"itemsize": 4}),
                   (bops.unshuffle, {"n": 4096, "itemsize": 4})):
        with pytest.raises(TypeError, match="DTensor"):
            fn(raw, **kw)
