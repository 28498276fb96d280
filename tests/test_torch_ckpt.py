"""Checkpoints across the two packages: the port names its variables as
the JAX package's `flatten_state` does, a checkpoint written by either
restores bit for bit in the other, and the port's example writes a series
the JAX package reads."""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.core.bp_engine import BpReader as JBpReader
from repro.core.bp_engine import EngineConfig as JEngineConfig
from repro.pic import simulation as jsim
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import EngineConfig
from repro_torch.core.darshan import CTR, MONITOR
from repro_torch.examples import pic_simulation
from repro_torch.pic import simulation as sim
from repro_torch.pic.convert import state_from_numpy, state_to_numpy

CFG = jsim.PicConfig(n_cells=64, capacity=1024, n_electrons=512,
                     n_ions=512, n_neutrals=512, rate_R=0.5, dt=1e-2)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    MONITOR.reset()
    yield
    torch.set_num_threads(n)


def _jax_state():
    state = jsim.init_sim(CFG, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in jckpt.flatten_state(state._asdict()).items()}
    return state, flat


def test_variable_names_match_jax_flatten_state():
    jstate, flat = _jax_state()
    tstate = state_from_numpy(flat, "cpu")
    names = list(ckpt.flatten_state(tstate._asdict()))
    assert names == list(jckpt.flatten_state(jstate._asdict()))
    assert names[:6] == ["electrons/.x", "electrons/.v", "electrons/.w",
                         "electrons/.alive", "electrons/.charge",
                         "electrons/.mass"]
    assert names[-5:] == ["neutrals/.mass", "step", "total_ionizations",
                          "wall_flux_e", "wall_flux_i"]
    assert "key" in names
    back = ckpt.unflatten_like(tstate._asdict(),
                               ckpt.flatten_state(tstate._asdict()))
    assert back["electrons"].x is tstate.electrons.x
    assert isinstance(back["ions"], type(tstate.ions))


def test_jax_checkpoint_restores_in_port(tmpdir_path):
    jstate, flat = _jax_state()
    jckpt.save_checkpoint(tmpdir_path, jstate._asdict(), 3, n_io_ranks=4,
                          engine_config=JEngineConfig(codec="blosc"))
    like = sim.init_sim(CFG, 9, device="cpu")._asdict()
    back, step = ckpt.restore_checkpoint(tmpdir_path, like)
    assert step == 3
    got = state_to_numpy(sim.PicState(**back))
    for k, v in flat.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert isinstance(back["electrons"].charge, float)


@pytest.mark.parametrize("device_compress,async_io",
                         [(False, False), (True, False), (True, True)])
def test_port_checkpoint_restores_in_jax(tmpdir_path, device_compress,
                                         async_io):
    jstate, flat = _jax_state()
    tstate = sim.pic_run_chunk(state_from_numpy(flat, "cpu"), CFG, 2)
    ckpt.save_checkpoint(tmpdir_path, tstate._asdict(), 2, n_io_ranks=4,
                         engine_config=EngineConfig(codec="blosc"),
                         device_compress=device_compress, async_io=async_io)
    if device_compress:     # x, w, alive (4C) and v (12C) a species + key
        expect = 3 * 24 * CFG.capacity + 8
        assert MONITOR.report()["total"][CTR.COMPRESS_DEVICE_BYTES] == expect
    like = jax.tree_util.tree_map(np.asarray, jstate._asdict())
    back, step = jckpt.restore_checkpoint(tmpdir_path, like)
    assert step == 2
    want = state_to_numpy(tstate)
    got = {k: np.asarray(v)
           for k, v in jckpt.flatten_state(back).items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # and the port restores its own checkpoint bit for bit
    tback, _ = ckpt.restore_checkpoint(tmpdir_path, tstate._asdict())
    for k, v in state_to_numpy(sim.PicState(**tback)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_restart_from_checkpoint_is_deterministic(tmpdir_path):
    state = sim.pic_run_chunk(sim.init_sim(CFG, 1, device="cpu"), CFG, 2)
    ckpt.save_checkpoint(tmpdir_path, state._asdict(), 2,
                         engine_config=EngineConfig(codec="blosc"),
                         device_compress=True)
    back, _ = ckpt.restore_checkpoint(tmpdir_path, state._asdict())
    a = state_to_numpy(sim.pic_run_chunk(state, CFG, 3))
    b = state_to_numpy(sim.pic_run_chunk(sim.PicState(**back), CFG, 3))
    for k, v in a.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)
    assert ckpt.list_checkpoints(tmpdir_path) == [2]


def test_port_example_writes_a_series_jax_reads(capsys):
    workdir = pic_simulation.main(["--scale", "1024", "--steps", "20",
                                   "--mvstep", "10", "--dmpstep", "10",
                                   "--device", "cpu"])
    try:
        assert "restart from step 20 OK -> continued to 120" in \
            capsys.readouterr().out
        with JBpReader(workdir / "diag.bp4") as r:
            assert r.valid_steps() == [10, 20]
            assert r.attributes(10)["software"] == "repro-jbp"
            rho = r.read_var(20, "/data/20/meshes/density_e")
            assert rho.shape == (100_000 // 1024,) and rho.sum() > 0
            x = r.read_var(20, "/data/20/particles/e/position/x")
            assert x.shape == ((1 << 25) // 1024,)
            assert ((x >= 0) & (x <= 1)).all()
        assert jckpt.list_checkpoints(workdir / "ckpt") == [10, 20]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
