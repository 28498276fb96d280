"""Port kernels (`repro_torch.kernels`) against the JAX package's Pallas
kernels (interpret mode on the CPU) and their oracles, at the cases of
tests/test_kernels.py. On a CPU tensor each wrapper runs its plain PyTorch
version; tests/test_torch_cuda.py holds the CUDA kernels against those on
the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import byte_shuffle
from repro.kernels.bitshuffle import ops as jbops
from repro.kernels.deposit import ops as jdops
from repro.kernels.deposit.ref import deposit_ref as jdeposit_ref
from repro_torch.kernels.bitshuffle import ops as bops
from repro_torch.kernels.deposit import ops as dops


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- bitshuffle
@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("n_bytes", [4096, 40_000, 123_456])
def test_shuffle_and_unshuffle_match_jax(itemsize, n_bytes):
    rng = np.random.default_rng(n_bytes)
    n_bytes -= n_bytes % itemsize
    raw = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    jshuf, jn = jbops.shuffle(jnp.asarray(raw), itemsize=itemsize)
    shuf, n = bops.shuffle(torch.from_numpy(raw), itemsize=itemsize)
    assert n == jn == n_bytes
    np.testing.assert_array_equal(shuf.numpy(), np.asarray(jshuf))
    back = bops.unshuffle(shuf, n, itemsize=itemsize)
    np.testing.assert_array_equal(back.numpy(), raw)
    jback = jbops.unshuffle(jshuf, jn, itemsize=itemsize)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("n_items", [1, 7, 512, 16384, 65521])
def test_shuffle_block_matches_jax_and_host(itemsize, n_items):
    rng = np.random.default_rng(itemsize * 100 + n_items)
    raw = rng.integers(0, 256, n_items * itemsize, dtype=np.uint8)
    got = bops.shuffle_block(torch.from_numpy(raw), itemsize=itemsize)
    oracle = np.frombuffer(byte_shuffle(raw.tobytes(), itemsize), np.uint8)
    np.testing.assert_array_equal(got.numpy(), oracle)
    jgot = jbops.shuffle_block(jnp.asarray(raw), itemsize=itemsize)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_shuffle_block_rejects_ragged_length_like_jax():
    with pytest.raises(ValueError):
        jbops.shuffle_block(jnp.zeros(10, jnp.uint8), itemsize=4)
    with pytest.raises(ValueError, match="len % itemsize"):
        bops.shuffle_block(torch.zeros(10, dtype=torch.uint8), itemsize=4)


def test_shuffle_block_dtype_views_match_host():
    rng = np.random.default_rng(99)
    for dtype in (np.float16, np.float32, np.float64, np.int32, np.uint64):
        for n in (3, 100, 1000, 4097):
            arr = (rng.normal(size=n) * 100).astype(dtype)
            raw = arr.view(np.uint8).reshape(-1)
            got = bops.shuffle_block(torch.from_numpy(raw.copy()),
                                     itemsize=arr.dtype.itemsize)
            oracle = byte_shuffle(raw.tobytes(), arr.dtype.itemsize)
            assert got.numpy().tobytes() == oracle, (dtype, n)


def test_cpu_tensors_never_count_as_launches():
    before = (dops.deposit.launches, bops.shuffle.launches,
              bops.shuffle_block.launches, bops.unshuffle.launches)
    x = torch.rand(100)
    dops.deposit(x, torch.ones(100), torch.ones(100), n_cells=8, dx=1 / 8)
    raw = torch.zeros(64, dtype=torch.uint8)
    out, n = bops.shuffle(raw, itemsize=4)
    bops.unshuffle(out, n, itemsize=4)
    bops.shuffle_block(raw, itemsize=4)
    assert (dops.deposit.launches, bops.shuffle.launches,
            bops.shuffle_block.launches, bops.unshuffle.launches) == before


# ------------------------------------------------------------------- deposit
def _particles(n, seed, dead=0.25):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, n).astype(np.float32)
    x[:3] = [0.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0.0))]
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    alive = (rng.uniform(0, 1, n) > dead).astype(np.float32)
    return x, w, alive


@pytest.mark.parametrize("n,n_cells", [(2000, 128), (5000, 300), (1024, 1024)])
def test_deposit_matches_jax_kernel_and_oracle(n, n_cells):
    x, w, alive = _particles(n, n)
    dx = 1.0 / n_cells
    got = dops.deposit(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(alive), n_cells=n_cells, dx=dx).numpy()
    jx, jw, ja = jnp.asarray(x), jnp.asarray(w), jnp.asarray(alive)
    for ref in (np.asarray(jdops.deposit(jx, jw, ja, n_cells=n_cells, dx=dx)),
                np.asarray(jdeposit_ref(jx, jw, ja, n_cells, dx))):
        rel = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-9)
        assert rel < 1e-4


def test_deposit_conserves_charge():
    rng = np.random.default_rng(9)
    n, n_cells = 4096, 256
    dx = 1.0 / n_cells
    x = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    rho = dops.deposit(x, torch.ones(n), torch.ones(n), n_cells=n_cells, dx=dx)
    assert abs(float(rho.double().sum()) * dx - n) / n < 1e-5


def test_deposit_rejects_empty_grid():
    with pytest.raises(ValueError):
        dops.deposit(torch.zeros(4), torch.ones(4), torch.ones(4), n_cells=0,
                     dx=1.0)
