"""Port PIC-MC modules (`repro_torch.pic`) against the JAX package's
`repro.pic` on the same numpy inputs, with JAX's random draws replayed
into the port. Masks, slots and counts must agree exactly; floats within
the tolerances stated at each comparison (float32 sums and products that
the two compilers may order or fuse differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import flatten_state as jflatten
from repro.pic import collisions as jcoll
from repro.pic import fields as jfields
from repro.pic import grid as jgrid
from repro.pic import particles as jpart
from repro.pic import simulation as jsim
from repro_torch.kernels.spawn import ops as spawn_ops
from repro_torch.kernels.spawn.ref import spawn_ref
from repro_torch.pic import collisions, fields, grid, particles
from repro_torch.pic import simulation as sim
from repro_torch.pic.convert import state_from_numpy, state_to_numpy

RTOL = 1e-5      # float32 state after several steps
ATOL = 1e-6      # positions and velocities are O(1e-2..1)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _species_np(rng, C, n_alive, *, vscale=1.0, L=1.0):
    x = rng.uniform(0, L, C).astype(np.float32)
    v = (rng.normal(size=(C, 3)) * vscale).astype(np.float32)
    w = rng.uniform(0.5, 1.5, C).astype(np.float32)
    alive = np.zeros(C, np.float32)
    alive[rng.permutation(C)[:n_alive]] = 1.0
    return x, v, w, alive


def _both(arrs, charge, mass):
    j = jpart.Species(*(jnp.asarray(a) for a in arrs), charge, mass)
    t = particles.Species(*(torch.from_numpy(a.copy()) for a in arrs),
                          charge, mass)
    return j, t


def _assert_species(t, j, rtol=1e-6, atol=1e-7):
    np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    for f in ("x", "v", "w"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


# ---------------------------------------------------------------- particles
def test_init_species_takes_given_positions_and_velocities():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, 64).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    sp = particles.init_species(None, 64, 40, L=1.0, v_thermal=0.5,
                                charge=-1.0, mass=1.0,
                                x=torch.from_numpy(x), v=torch.from_numpy(v))
    jsp = jpart.init_species(jax.random.PRNGKey(0), 64, 40, L=1.0,
                             v_thermal=0.5, charge=-1.0, mass=1.0)
    np.testing.assert_array_equal(sp.x.numpy(), x)
    np.testing.assert_array_equal(sp.v.numpy(), v)
    for f in ("w", "alive"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(),
                                      np.asarray(getattr(jsp, f)))
    assert float(sp.count()) == float(jsp.count()) == 40
    drawn = particles.init_species(torch.Generator().manual_seed(1), 64, 40,
                                   L=2.0, v_thermal=0.5, charge=1.0,
                                   mass=2.0, device="cpu")
    assert drawn.x.min() >= 0 and drawn.x.max() < 2.0
    assert drawn.v.shape == (64, 3) and drawn.x.dtype == torch.float32


@pytest.mark.parametrize("boundary", ["periodic", "absorbing"])
def test_push_matches_jax(boundary):
    rng = np.random.default_rng(1)
    C = 4096
    arrs = _species_np(rng, C, 3000, vscale=30.0)   # many cross a wall
    js, ts = _both(arrs, -1.0, 1.0)
    E = rng.normal(size=C).astype(np.float32) * 10
    jout, jwall = jpart.push(js, jnp.asarray(E), 1e-3, 1.0, boundary=boundary)
    tout, twall = particles.push(ts, torch.from_numpy(E), 1e-3, 1.0,
                                 boundary=boundary)
    _assert_species(tout, jout)
    np.testing.assert_allclose(float(twall), float(jwall), rtol=1e-6)
    if boundary == "absorbing":
        assert float(twall) > 0
        assert tout.alive.sum() < ts.alive.sum()


# dead slots scattered (as absorbing walls and ionization leave them) or
# at the tail (a fresh species); all dead, none dead; events under, at and
# over the dead count
@pytest.mark.parametrize("n_dead,n_events,tail", [
    (1000, 300, False), (50, 400, False), (0, 10, False),
    (2048, 300, False), (2048, 2048, False), (0, 0, False),
    (700, 700, True), (100, 400, True)],
    ids=["1000-300", "50-400", "0-10", "all_dead", "all_dead-all_events",
         "none_dead-no_events", "tail-700-700", "tail-100-400"])
def test_spawn_matches_jax_including_overflow(n_dead, n_events, tail):
    rng = np.random.default_rng(n_dead + n_events)
    C = 2048
    arrs = _species_np(rng, C, C - n_dead)
    if tail:
        arrs[3][:] = np.arange(C) < C - n_dead
    js, ts = _both(arrs, 1.0, 1836.0)
    new_x = rng.uniform(0, 1, C).astype(np.float32)
    new_v = rng.normal(size=(C, 3)).astype(np.float32)
    new_w = rng.uniform(0.5, 1.5, C).astype(np.float32)
    mask = np.zeros(C, bool)
    mask[rng.permutation(C)[:n_events]] = True
    jout, jdrop = jpart.spawn(js, jnp.asarray(new_x), jnp.asarray(new_v),
                              jnp.asarray(new_w), jnp.asarray(mask))
    tout, tdrop = particles.spawn(ts, torch.from_numpy(new_x),
                                  torch.from_numpy(new_v),
                                  torch.from_numpy(new_w),
                                  torch.from_numpy(mask))
    assert int(tdrop) == int(jdrop) == max(n_events - n_dead, 0)
    # same slots written with the same values: exact
    _assert_species(tout, jout, rtol=0, atol=0)
    assert float(tout.count()) == C - n_dead + min(n_events, n_dead)


def test_spawn_on_cpu_tensors_takes_the_plain_version(monkeypatch):
    calls = []

    def plain(*args):
        calls.append(args[0].shape[0])
        return spawn_ref(*args)
    monkeypatch.setattr(spawn_ops, "spawn_ref", plain)
    monkeypatch.setattr(spawn_ops.spawn, "launches", 0)
    cfg = sim.PicConfig(n_cells=32, capacity=512, n_electrons=128,
                        n_ions=128, n_neutrals=256, rate_R=50.0)
    state = sim.pic_run_chunk(sim.init_sim(cfg, 3, device="cpu"), cfg, 3)
    # ionize spawns electrons and ions once each a step, on the CPU
    assert calls == [512] * 6
    assert spawn_ops.spawn.launches == 0
    assert float(state.total_ionizations) > 0


# --------------------------------------------------------------------- grid
def test_gather_field_and_smoothing_match_jax():
    rng = np.random.default_rng(2)
    n_cells, dx = 128, 1.0 / 128
    x = rng.uniform(0, 1, 4096).astype(np.float32)
    x[:2] = [0.0, 1.0]
    E = rng.normal(size=n_cells).astype(np.float32)
    got = grid.gather_field(torch.from_numpy(E), torch.from_numpy(x), dx)
    ref = jgrid.gather_field(jnp.asarray(E), jnp.asarray(x), dx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    rho = rng.uniform(0, 1, n_cells).astype(np.float32)
    sm = grid.smooth_121(torch.from_numpy(rho))
    np.testing.assert_allclose(sm.numpy(),
                               np.asarray(jgrid.smooth_121(jnp.asarray(rho))),
                               rtol=1e-6)
    # interior-conserving up to boundary treatment (tests/test_pic.py)
    assert abs(float(sm.sum() - rho.sum())) / float(rho.sum()) < 0.02


def test_deposit_gather_adjointness():
    rng = np.random.default_rng(1)
    n, n_cells, dx = 1000, 64, 1.0 / 64
    x = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    F = torch.from_numpy(rng.normal(size=n_cells).astype(np.float32))
    lhs = float(torch.sum(grid.gather_field(F, x, dx) * w))
    rho = grid.deposit_cic(x, w, torch.ones(n), n_cells, dx)
    rhs = float(torch.sum(F * rho) * dx)
    assert abs(lhs - rhs) / abs(lhs) < 1e-3


# ------------------------------------------------------------------- fields
def test_thomas_matches_dense_and_jax():
    rng = np.random.default_rng(0)
    n = 64
    a = rng.normal(size=n).astype(np.float32) * 0.1
    b = (2.0 + rng.uniform(0, 1, n)).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32) * 0.1
    d = rng.normal(size=n).astype(np.float32)
    M = np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    x = fields.thomas_solve(*(torch.from_numpy(v) for v in (a, b, c, d)))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(M, d), rtol=2e-4,
                               atol=2e-4)
    jx = jfields.thomas_solve(*(jnp.asarray(v) for v in (a, b, c, d)))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-4, atol=2e-4)


def test_poisson_matches_jax_and_converges():
    errs = {}
    for n in (128, 512):
        dx = 1.0 / n
        xs = (np.arange(n) + 1.0) * dx
        kw = 2 * np.pi
        rho = np.sin(kw * xs).astype(np.float32)
        phi, E = fields.solve_poisson(torch.from_numpy(rho), dx)
        jphi, jE = jfields.solve_poisson(jnp.asarray(rho), dx)
        np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(E.numpy(), np.asarray(jE), rtol=2e-4,
                                   atol=2e-4)
        phi_ref = np.sin(kw * xs) / kw**2
        errs[n] = np.max(np.abs(phi.numpy() - phi_ref)) / np.max(np.abs(phi_ref))
    assert errs[512] < 5e-2
    assert errs[512] < errs[128]


# --------------------------------------------------------------- collisions
def test_ionize_with_replayed_jax_draws():
    rng = np.random.default_rng(3)
    C, n_cells, L = 4096, 256, 1.0
    e_np = _species_np(rng, C, 2048)
    i_np = _species_np(rng, C, 2048, vscale=0.02)
    n_np = _species_np(rng, C, 3000, vscale=0.02)
    je, te = _both(e_np, -1.0, 1.0)
    ji, ti = _both(i_np, 1.0, 1836.0)
    jn, tn = _both(n_np, 0.0, 1836.0)
    ne = (rng.uniform(0, 40, n_cells)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(rate_R=0.5, dt=1e-2, L=L, n_cells=n_cells)
    je2, ji2, jn2, jinfo = jcoll.ionize(key, je, ji, jn,
                                        electron_density_per_cell=jnp.asarray(ne),
                                        **kw)
    u = np.array(jax.random.uniform(key, (C,)))
    kick = np.array(jax.random.normal(jax.random.fold_in(key, 1), (C, 3)))
    te2, ti2, tn2, tinfo = collisions.ionize(
        None, te, ti, tn, electron_density_per_cell=torch.from_numpy(ne),
        u=torch.from_numpy(u), kick=torch.from_numpy(kick), **kw)
    assert int(tinfo["ionizations"]) == int(jinfo["ionizations"]) > 100
    assert int(tinfo["dropped"]) == int(jinfo["dropped"])
    np.testing.assert_array_equal(tn2.alive.numpy(), np.asarray(jn2.alive))
    _assert_species(te2, je2)
    _assert_species(ti2, ji2)


# --------------------------------------------------------------- simulation
def _jax_flat(state):
    return {k: np.asarray(v) for k, v in jflatten(state._asdict()).items()}


def _assert_state(t_state, j_state, *, skip=("key",)):
    t_flat, j_flat = state_to_numpy(t_state), _jax_flat(j_state)
    assert sorted(t_flat) == sorted(j_flat)
    for k, jv in j_flat.items():
        if k in skip:
            continue
        tv = t_flat[k]
        if k.endswith(".alive") or k == "step" or k == "total_ionizations":
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(tv, np.float64),
                                       np.asarray(jv, np.float64),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def _run_both(cfg, n_steps):
    jstate = jsim.init_sim(cfg, jax.random.PRNGKey(0))
    tstate = state_from_numpy(_jax_flat(jstate), "cpu")
    C = cfg.capacity
    for _ in range(n_steps):
        _, sub = jax.random.split(jstate.key)
        draws = {"u": torch.from_numpy(np.array(
                     jax.random.uniform(sub, (C,)))),
                 "kick": torch.from_numpy(np.array(jax.random.normal(
                     jax.random.fold_in(sub, 1), (C, 3))))}
        jstate = jsim.pic_step(jstate, cfg)
        tstate = sim.pic_step(tstate, cfg, draws=draws)
    return jstate, tstate


def test_pic_steps_match_jax_with_replayed_keys():
    cfg = jsim.PicConfig(n_cells=256, capacity=4096, n_electrons=2048,
                         n_ions=2048, n_neutrals=2048, rate_R=0.5, dt=1e-2)
    jstate, tstate = _run_both(cfg, 5)
    assert float(tstate.total_ionizations) > 50
    _assert_state(tstate, jstate)


def test_field_solve_absorbing_steps_match_jax():
    cfg = jsim.PicConfig(n_cells=128, capacity=2048, n_electrons=1024,
                         n_ions=1024, n_neutrals=256, boundary="absorbing",
                         field_solve=True, smoothing=True, dt=1e-3,
                         rate_R=0.0)
    jstate, tstate = _run_both(cfg, 3)
    _assert_state(tstate, jstate)


def test_diagnostics_match_jax():
    cfg = jsim.PicConfig(n_cells=256, capacity=4096, n_electrons=2048,
                         n_ions=2048, n_neutrals=2048, rate_R=0.5, dt=1e-2)
    jstate, tstate = _run_both(cfg, 2)
    jd = jsim.diagnostics(jstate, cfg)
    td = sim.diagnostics(tstate, cfg)
    assert sorted(td) == sorted(jd)
    for k, jv in jd.items():
        tv = td[k]
        if k.startswith(("vdist/", "edist/")):
            assert tv.dtype == np.float32
            np.testing.assert_array_equal(tv, jv, err_msg=k)
            assert tv.sum() > 0
        elif isinstance(jv, np.ndarray):
            np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(tv, jv, rtol=RTOL, err_msg=k)


def test_histogram_follows_numpy_edge_rules():
    v = torch.tensor([-0.1, 0.0, 0.5, 2.5, 4.99, 5.0, 5.01, float("nan")])
    w = torch.ones_like(v)
    got = sim._histogram(v, w, 5, 0.0, 5.0).numpy()
    ref, _ = np.histogram(v.numpy()[:-1], bins=5, range=(0.0, 5.0))
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_port_run_is_deterministic_and_conserves_particles():
    cfg = sim.PicConfig(n_cells=256, capacity=4096, n_electrons=2048,
                        n_ions=2048, n_neutrals=2048, rate_R=0.5, dt=1e-2)
    a = sim.pic_run_chunk(sim.init_sim(cfg, 3, device="cpu"), cfg, 4)
    b = sim.pic_run_chunk(sim.init_sim(cfg, 3, device="cpu"), cfg, 4)
    for k, v in state_to_numpy(a).items():
        np.testing.assert_array_equal(v, state_to_numpy(b)[k], err_msg=k)
    d0 = sim.diagnostics(sim.init_sim(cfg, 3, device="cpu"), cfg)
    d1 = sim.diagnostics(a, cfg)
    assert d1["ionizations"] > 0
    assert (d1["count/D"] + d1["count/D_plus"]
            == d0["count/D"] + d0["count/D_plus"])
    assert (d1["count/e"] - d1["count/D_plus"]
            == d0["count/e"] - d0["count/D_plus"])
