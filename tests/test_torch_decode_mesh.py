"""The port's prefill and decode steps over a (2, 2) ("data", "model")
mesh of 4 gloo ranks on the CPU (one module-scoped `RankPool`), with the
caches laid out by `launch.sharding.cache_sharding_tree`, against two
references from the same numpy-seeded params, prompt and decode inputs:
the port's one-device prefill and decode, and the JAX package's
`prefill` and `decode_step` jitted on 4 host devices under `use_mesh`
with `param_sharding_tree` and `cache_sharding_tree` of a concrete
`compat_make_mesh((2, 2), ("data", "model"))` (a subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=4
--xla_allow_excess_precision=false`, started by the module's first test
and running beside the ranks).

One family a case at smoke width: dense (smollm, heads over `model`),
dense with 4 query heads over 1 kv head (smollm's GQA: the kv weights
stay whole over `model` and the cache falls back to sharding its
head_dim, whose partial scores are all-reduced before the softmax),
hybrid (zamba2), ssm (mamba2), moe (deepseek-moe on its no-drop
copy, `capacity_factor = n_experts / top_k`, as ROADMAP Queue 3 holds it:
capacity dispatch is not causal), vlm (llama-3.2-vision, cross caches
from the prefill) and audio (musicgen, decoding from `embeds=`). The
decode is teacher-forced: each step takes the case's next numpy token
(or embedding) whatever the last logits chose.

Tolerance: bf16 rounds at the same points on all three, but sums run in
other orders (the mesh's partial sums, XLA's fusions). The logits of the
prefill's last position and of each decode step within 2e-2 of the
reference's largest |logit| (at least 1); the caches after the last step
within 5e-2 of their largest |value| (bf16 leaves that carry each step's
rounding). The mesh is held to that against the one device. Against the
JAX side, where the two references are further apart than that, each
number is held to twice their distance (the noise floor). A moe token
near a routing tie picks another expert on another sum order (the mesh's
bf16 partial sums move most activations by an ulp), and its row then
parts from the reference far past any rounding: so the moe case records
each MoE call's top-k experts on one device and replays them on the mesh
(`moe.route`'s choice; the weights are the mesh's own probabilities at
those experts), which holds everything else of the mesh's decode to the
tolerance against the one device; the JAX side routes freely, and the
noise floor is for that. The mesh's own top-k experts equal the one
device's on every token whose k-th probability clears the next by more
than 2e-2. After the prefill and after every decode step each cache
leaf's placements are `to_placements` of `cache_pspec_tree`'s spec for
it.

No JAX at the module's top level: the rank processes import this
module."""
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
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as S
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.steps import (grow_cache, make_decode_step,
                                     make_prefill_step)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_mesh_step import _nest, _np_params, _routes  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
B, PROMPT, STEPS, MAX_SEQ = 4, 16, 3, 24
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssd_chunk=16)
#: name -> (arch, config overrides; "no_drop": capacity for every token)
CASES = {
    "dense": ("smollm-360m", {}),
    "dense_hd_fallback": ("smollm-360m", {"n_kv_heads": 1}),
    "hybrid": ("zamba2-2.7b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "moe": ("deepseek-moe-16b", {"no_drop": True}),
    "vlm": ("llama-3.2-vision-90b", {}),
    "audio": ("musicgen-large", {}),
}
#: the stated tolerances, as fractions of the reference's largest value
TOL = {"logits": 2e-2, "cache": 5e-2}


def _cfg(case):
    arch, over = CASES[case]
    over = dict(over)
    cfg = reduce_for_smoke(get_config(arch))
    if over.pop("no_drop", False):
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    return dataclasses.replace(cfg, **over)


def _np_inputs(cfg, seed=1) -> dict:
    """The prompt (tokens, or embeddings for the audio family), the vlm's
    image tokens, and the teacher-forced decode inputs."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["embeds"] = rng.standard_normal(
            (B, PROMPT, cfg.d_model)).astype(np.float32)
        out["step_embeds"] = rng.standard_normal(
            (STEPS, B, 1, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (B, PROMPT)).astype(np.int32)
        out["step_tokens"] = rng.integers(0, cfg.vocab_size,
                                          (STEPS, B, 1)).astype(np.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _leaves_np(tree, prefix="") -> dict:
    """Flat {path: fp32 numpy} of a cache tree, DTensors gathered."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_np(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves_np(v, f"{prefix}{i}/"))
        return out
    t = tree.full_tensor() if meshctx.is_dtensor(tree) else tree
    return {prefix.rstrip("/"): t.float().numpy()}


def _placements_ok(cfg, cache, mesh) -> list:
    """The cache leaves whose placements differ from `cache_pspec_tree`'s."""
    want = _leaves_of(S.cache_sharding_tree(cfg, mesh, cache))
    got = _leaves_of(cache)
    return [(i, tuple(g.placements), tuple(w.placements))
            for i, (g, w) in enumerate(zip(got, want))
            if not meshctx.is_dtensor(g)
            or tuple(g.placements) != tuple(w.placements)]


def _leaves_of(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_of(v)]
    return [tree]


def _run(case, params, inputs, mesh=None):
    """The prefill and the teacher-forced decode: ({name: logits}, the
    cache after the last step, placement faults, greedy tokens of the
    serve steps)."""
    cfg = _cfg(case)
    batch = {k: torch.from_numpy(inputs[k]) for k in
             ("tokens", "embeds", "vision_embeds") if k in inputs}
    if "tokens" in batch:
        batch["tokens"] = batch["tokens"].long()
    if mesh is not None:
        from repro_torch.train.state import shard_batch
        batch = shard_batch(batch, mesh)
    out, faults, greedy = {}, [], []
    with torch.no_grad():
        logits, cache = M.prefill(params, cfg, batch, **CHUNKS)
        out["prefill"] = logits[:, -1:]
        cache = grow_cache(cache, MAX_SEQ)
        if mesh is not None:
            faults += [("prefill", f) for f in _placements_ok(cfg, cache,
                                                              mesh)]
        for i in range(STEPS):
            tok = emb = None
            if cfg.family == "audio":
                emb = torch.from_numpy(inputs["step_embeds"][i])
            else:
                tok = torch.from_numpy(inputs["step_tokens"][i]).long()
            logits, cache = M.decode_step(params, cfg, tok, cache,
                                          PROMPT + i, embeds=emb)
            out[f"step{i}"] = logits
            if mesh is not None:
                faults += [(f"step{i}", f) for f in
                           _placements_ok(cfg, cache, mesh)]
        # the serve steps on the same params: a prefill, one greedy step
        pre = make_prefill_step(cfg, **CHUNKS)(params, batch)
        c2 = grow_cache(pre[1], MAX_SEQ)
        tok = torch.argmax(pre[0][:, -1], dim=-1)[:, None]
        emb = (torch.from_numpy(inputs["step_embeds"][0])
               if cfg.family == "audio" else None)
        nxt, _ = make_decode_step(cfg)(params, c2, tok, PROMPT, emb)
        greedy = [tok, nxt]
    full = {k: (v.full_tensor() if meshctx.is_dtensor(v) else v)
            .float().numpy() for k, v in out.items()}
    greedy = [(t.full_tensor() if meshctx.is_dtensor(t) else t).numpy()
              for t in greedy]
    return full, _leaves_np(cache), faults, greedy


def _params(case, d):
    cfg = _cfg(case)
    flat = dict(np.load(d / f"{case}.params.npz"))
    return params_from_numpy(cfg, _nest(flat), device="cpu")


def _inputs(case, d):
    return dict(np.load(d / f"{case}.inputs.npz"))


# ------------------------------------------------------------- rank tasks
def _rank_decode(case, d):
    """The case's prefill and decode on the (2, 2) mesh: rank 0's result
    (the logits, the final cache (numpy), the placement faults and the
    greedy tokens; None on the other ranks), and where the routes are
    replayed, the rank's first batch row and the experts its own top-k
    chose at each MoE call."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.optim.tree import tree_map
    d = pathlib.Path(d)
    cfg = _cfg(case)
    mesh = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    sh = S.param_sharding_tree(cfg, mesh, M.param_shapes(cfg))
    params = tree_map(lambda t, s: distribute_tensor(t, s.mesh,
                                                     s.placements),
                      _params(case, d), sh)
    routes = d / f"{case}.routes.npz"
    rows, own = slice(None), None
    if routes.exists():
        n = B // mesh.size(0)
        at = mesh.get_local_rank(0) * n
        rows = slice(at, at + n)
    with (_routes(routes, rows) if routes.exists() else
          contextlib.nullcontext()) as rec:
        res = _run(case, params, _inputs(case, d), mesh)
    if rec is not None:
        own = (rows.start, rec.calls)
    return (res if torch.distributed.get_rank() == 0 else None), own


# ------------------------------------------------------------------ the JAX side
_JAX_SIDE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config, reduce_for_smoke
from repro.launch.mesh import compat_make_mesh
from repro.launch.sharding import (batch_sharding_for, cache_sharding_tree,
                                   param_sharding_tree, replicated)
from repro.meshctx import use_mesh
from repro.models import model as M

d, cases, chunks, max_seq = json.loads(sys.argv[1])
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


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree, np.float32)}


for case, (arch, over) in cases.items():
    cfg = reduce_for_smoke(get_config(arch))
    if over.pop("no_drop", False):
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    cfg = dataclasses.replace(cfg, **over)
    params = nest(dict(np.load(f"{d}/{case}.params.npz")))
    inp = dict(np.load(f"{d}/{case}.inputs.npz"))
    psh = param_sharding_tree(cfg, mesh, params)
    params = jax.device_put(params, psh)
    batch = {k: jnp.asarray(inp[k]) for k in
             ("tokens", "embeds", "vision_embeds") if k in inp}
    bsh = {k: batch_sharding_for(mesh, v) for k, v in batch.items()}
    batch = jax.device_put(batch, bsh)
    out = {}
    with use_mesh(mesh):
        pre = jax.jit(lambda p, b: M.prefill(p, cfg, b, **chunks),
                      in_shardings=(psh, bsh))
        logits, cache = pre(params, batch)
        out["prefill"] = np.asarray(logits[:, -1:], np.float32)

        def grow(path, t):
            name = getattr(path[-1], "key", "")
            if name in ("k", "v"):
                pad = [(0, 0)] * t.ndim
                pad[-3] = (0, max_seq - t.shape[-3])
                return jnp.pad(t, pad)
            return t
        cache = jax.tree_util.tree_map_with_path(grow, cache)
        csh = cache_sharding_tree(cfg, mesh, cache)
        cache = jax.device_put(cache, csh)
        audio = cfg.family == "audio"
        tsh = batch_sharding_for(mesh, jnp.zeros((4, 1), jnp.int32),
                                 batch_axes=("data",))
        step = jax.jit(
            lambda p, c, t, n, e: M.decode_step(p, cfg, t, c, n, embeds=e),
            in_shardings=(psh, csh, tsh, replicated(mesh),
                          batch_sharding_for(mesh, jnp.zeros((4, 1, 8)),
                                             batch_axes=("data",))
                          if audio else None),
            out_shardings=(None, csh))
        for i in range(len(inp.get("step_tokens", inp.get("step_embeds")))):
            tok = (jnp.zeros((4, 1), jnp.int32) if audio else
                   jnp.asarray(inp["step_tokens"][i]))
            emb = jnp.asarray(inp["step_embeds"][i]) if audio else None
            logits, cache = step(params, cache, tok,
                                 jnp.asarray(16 + i, jnp.int32), emb)
            out[f"step{i}"] = np.asarray(logits, np.float32)
    np.savez(f"{d}/{case}.jax.logits.npz", **out)
    np.savez(f"{d}/{case}.jax.cache.npz", **flat(cache))
print("done")
"""


class _JaxRun:
    """The JAX side, running in the background from the module's first
    use."""

    def __init__(self, d):
        self.d = d
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   JAX_PLATFORMS="cpu")
        arg = json.dumps([str(d), CASES, CHUNKS, MAX_SEQ])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_SIDE, arg], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._done = None

    def result(self, case) -> tuple[dict, dict]:
        if self._done is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-4000:]
            self._done = True
        return (dict(np.load(self.d / f"{case}.jax.logits.npz")),
                dict(np.load(self.d / f"{case}.jax.cache.npz")))

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
    """The numpy params and inputs of every case, and the JAX side
    started on them."""
    d = tmp_path_factory.mktemp("decode_mesh")
    for case in CASES:
        cfg = _cfg(case)
        np.savez(d / f"{case}.params.npz", **_np_params(cfg))
        np.savez(d / f"{case}.inputs.npz", **_np_inputs(cfg))
    run = _JaxRun(d)
    yield d, run
    run.close()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with D.RankPool(4, tmp_path_factory.mktemp("store"), timeout=300) as p:
        yield p


def _errors(got: dict, want: dict) -> dict:
    """Each array's largest gap over the reference's largest |value| (at
    least 1)."""
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(1.0, float(np.abs(want[k]).max())))
            for k in want}


def _check(errors: dict, floor: dict, tol: float, what: str):
    for k, e in errors.items():
        bound = max(tol, 2.0 * floor[k])
        assert e <= bound, (what, k, e, tol, floor[k])


@pytest.mark.parametrize("case", list(CASES))
def test_decode_on_2x2_matches_the_one_device_and_jax_decodes(pool, inputs,
                                                              case):
    d, jax_run = inputs
    with _routes() as rec:
        one, one_cache, _, one_greedy = _run(case, _params(case, d),
                                             _inputs(case, d))
    moe = _cfg(case).family == "moe"
    if moe:
        rec.save(d / f"{case}.routes.npz")
    ranks = pool.run(_rank_decode, case, str(d))
    got, cache, faults, greedy = ranks[0][0]
    # every cache leaf laid out as cache_pspec_tree says, at every step
    assert faults == []
    want, want_cache = jax_run.result(case)
    assert sorted(one_cache) == sorted(want_cache)
    floor = _errors(one, want)
    cfloor = _errors(one_cache, want_cache)
    # the mesh and the one device share their routes (moe) or have none:
    # the mesh is held to the tolerance itself against the one device
    _check(_errors(got, one), {k: 0.0 for k in floor}, TOL["logits"],
           "logits vs one device")
    _check(_errors(got, want), floor, TOL["logits"], "logits vs jax")
    _check(_errors(cache, one_cache), {k: 0.0 for k in cfloor},
           TOL["cache"], "cache vs one device")
    _check(_errors(cache, want_cache), cfloor, TOL["cache"], "cache vs jax")
    if moe:
        # the mesh's own routing: its top-k experts (as a set) equal the
        # one device's on every token whose k-th probability clears the
        # next by more than the tolerance. The calls of the last forward,
        # the serve decode step, are left out: its input is each run's own
        # greedy token.
        forwards = STEPS + 3        # prefill, STEPS decodes, serve's two
        assert len(rec.calls) % forwards == 0
        n = len(rec.calls) - len(rec.calls) // forwards
        clear = 0
        for at, calls in (own for _, own in ranks):
            assert len(calls) == len(rec.calls)
            for mine, one_e, margin in zip(calls[:n], rec.calls,
                                           rec.margins):
                rows = slice(at, at + mine.shape[0])
                ok = margin[rows] > TOL["logits"]
                assert (np.sort(mine, -1)[ok]
                        == np.sort(one_e[rows], -1)[ok]).all()
                clear += int(ok.sum())
        assert clear > 0
    else:
        # no routing: the references agree within the tolerance themselves
        # (the JAX side routes freely)
        _check(floor, {k: 0.0 for k in floor}, TOL["logits"], "references")
        _check(cfloor, {k: 0.0 for k in cfloor}, TOL["cache"],
               "references")
    assert all(np.isfinite(v).all() for v in got.values())
    # the serve steps' greedy tokens: the prefill's argmax and one step
    for g, o, name in zip(greedy, one_greedy, ("prefill", "step0")):
        assert g.shape == (B, 1), name
        if name == "prefill":
            _agree_where_clear(g, o, one["prefill"])


def _agree_where_clear(got_tok, one_tok, logits):
    """Greedy tokens equal wherever the reference's top two logits are
    further apart than the logits' tolerance."""
    top2 = np.sort(logits[:, -1], axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TOL["logits"] * max(
        1.0, float(np.abs(logits).max()))
    assert (got_tok[clear] == one_tok[clear]).all()


def _rank_greedy(batch):
    """`serve.steps.greedy` of vocab-sharded logits on the (2, 2) mesh
    against `torch.argmax` of the whole logits, and one serve decode step
    of mamba2's smoke config at `batch` (1: the batch whole over
    `data`)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.optim.tree import tree_map
    from repro_torch.serve.steps import greedy
    mesh = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    g = torch.Generator().manual_seed(batch)
    whole = torch.randn(batch, 512, generator=g)
    logits = distribute_tensor(whole, mesh, meshctx.placements(
        (batch, 512), meshctx.BATCH, "model", mesh=mesh))
    got = greedy(logits).full_tensor()
    cfg = reduce_for_smoke(get_config("mamba2-2.7b"))
    sh = S.param_sharding_tree(cfg, mesh, M.param_shapes(cfg))
    params = tree_map(lambda t, s: distribute_tensor(t, mesh, s.placements),
                      M.init_params(cfg, 0, device="cpu"), sh)
    cache = M.lay_out_cache(cfg, M.init_decode_cache(cfg, batch, 8,
                                                     device="cpu"), mesh)
    with torch.no_grad():
        tok, _ = make_decode_step(cfg)(params, cache,
                                       torch.zeros(batch, 1).long(), 3)
    return (torch.equal(got, torch.argmax(whole, dim=-1)),
            tuple(tok.full_tensor().shape))


@pytest.mark.parametrize("batch", [1, 4])
def test_greedy_over_a_vocab_sharded_mesh(pool, batch):
    for same, shape in pool.run(_rank_greedy, batch):
        assert same and shape == (batch, 1)


def test_the_gqa_case_takes_the_head_dim_fallback():
    """4 query heads over 1 kv head on `model` = 2: the kv weights stay
    whole over `model` and the cache shards its head_dim."""
    mesh = tmesh.AbstractMesh((2, 2), AXES)
    cfg = _cfg("dense_hd_fallback")
    assert S.attn_layouts(cfg, 2) == (("model", None), (None, None))
    spec = S.cache_pspec_tree(cfg, mesh, M.make_decode_cache_spec(
        cfg, B, MAX_SEQ))["k"]
    assert tuple(spec) == (None, "data", None, None, "model")
    assert S.cache_pspec_tree(_cfg("dense"), mesh, M.make_decode_cache_spec(
        _cfg("dense"), B, MAX_SEQ))["k"] == S.P(None, "data", None, "model",
                                                 None)


def test_decode_step_takes_embeds_as_the_jax_package_does():
    """musicgen-large's smoke config decodes from embeddings: the port's
    `decode_step(..., embeds=)` against `repro.models.model.decode_step(
    ..., embeds=)` on the same params, cache and embeddings, one device.
    Logits within the stated tolerance of the reference's largest
    |logit|."""
    import jax.numpy as jnp
    from repro.models import model as JM
    cfg = _cfg("audio")
    flat = _np_params(cfg)
    inp = _np_inputs(cfg)
    params = params_from_numpy(cfg, _nest(flat), device="cpu")
    rng = np.random.default_rng(3)
    cache_np = {k: (rng.standard_normal(s.shape) * 0.5).astype(np.float32)
                for k, s in M.make_decode_cache_spec(cfg, B, MAX_SEQ).items()}
    cache = {k: torch.from_numpy(v).bfloat16() for k, v in cache_np.items()}
    emb = inp["step_embeds"][0]
    with torch.no_grad():
        got, cache = M.decode_step(params, cfg, None, cache, PROMPT,
                                   embeds=torch.from_numpy(emb))
    jparams = _nest({n: jnp.asarray(a) for n, a in flat.items()})
    jcache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache_np.items()}
    want, jcache = JM.decode_step(jparams, cfg, None, jcache, PROMPT,
                                  embeds=jnp.asarray(emb))
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max() / max(
        1.0, np.abs(want).max())
    assert err <= TOL["logits"], err
    got_c = {k: v.float().numpy() for k, v in cache.items()}
    want_c = {k: np.asarray(v, np.float32) for k, v in jcache.items()}
    _check(_errors(got_c, want_c), {k: 0.0 for k in got_c}, TOL["cache"],
           "cache")
