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
from repro.kernels.flash_attention import ops as jfops
from repro.kernels.ssd_scan import ops as jsops
from repro.models import attention as JA
from repro.models import ssm as JS
from repro_torch.kernels.bitshuffle import ops as bops
from repro_torch.kernels.deposit import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (flash_attention_plain,
                                                     reference_attention)
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked,
                                              ssd_recurrent_reference)

BF16_ULP = 2.0 ** -7


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


# a leaf shorter than one block, an exact multiple, a ragged last block, a
# last block that is not a multiple of the item size, and blocks that are
# not (999): such a block passes through, as the write path leaves it
@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("n_bytes,block", [
    (1000, 4096), (3 * 4096, 4096), (3 * 4096 + 1000, 4096),
    (3 * 4096 + 6, 4096), (10_000, 999)])
def test_shuffle_blocks_matches_jax_per_block_and_host(itemsize, n_bytes,
                                                       block):
    rng = np.random.default_rng(itemsize * 1000 + n_bytes + block)
    raw = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    before = bops.shuffle_blocks.launches
    got = bops.shuffle_blocks(torch.from_numpy(raw), block=block,
                              itemsize=itemsize).numpy()
    assert bops.shuffle_blocks.launches == before       # CPU: plain version
    host = b"".join(byte_shuffle(raw[i:i + block].tobytes(), itemsize)
                    for i in range(0, n_bytes, block))
    assert got.tobytes() == host
    jax = [np.asarray(jbops.shuffle_block(jnp.asarray(s), itemsize=itemsize))
           if len(s) % itemsize == 0 else s
           for s in (raw[i:i + block] for i in range(0, n_bytes, block))]
    np.testing.assert_array_equal(got, np.concatenate(jax))


def test_shuffle_blocks_rejects_a_bad_block():
    with pytest.raises(ValueError, match="block > 0"):
        bops.shuffle_blocks(torch.zeros(8, dtype=torch.uint8), block=0,
                            itemsize=4)


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


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def assert_ulps(got, ref, ulps=1.0):
    """|got - ref| <= ulps bf16 ulps (2^-7) of max |ref|, everywhere: both
    round to bf16 at the same points and differ only where an fp32 sum
    taken in another order rounds the other way."""
    g, r = f32(got), f32(ref)
    assert g.shape == r.shape
    err, top = np.abs(g - r).max(), np.abs(r).max()
    assert err <= ulps * BF16_ULP * top, (err, top)


def bf16_pair(a):
    """The same bf16 values in JAX and in torch."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(np.asarray(a, np.float32)).bfloat16())


# -------------------------------------------------- flash attention (plain)
def _qkv(S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, S, 2, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("S", [128, 256, 320])
@pytest.mark.parametrize("D", [32, 64, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_oracles(S, D, causal):
    q, k, v = _qkv(S, D, S + D)
    # fp32 in: the TPU kernel's function (p and out stay fp32), so the
    # plain version meets the Pallas kernel and the O(S^2) reference at
    # tests/test_kernels.py's fp32 tolerance
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, q_chunk=128, kv_chunk=128)
    pallas = jfops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, qc=128, kc=128,
                                   interpret=True)
    ref = JA.reference_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    assert np.abs(f32(got) - f32(pallas)).max() < 2e-5
    assert np.abs(f32(got) - f32(ref)).max() < 2e-5
    # bf16 in (the model's case): the jnp oracle's rounding points exactly;
    # against the Pallas kernel, tests/test_kernels.py's bf16 tolerance
    (qj, qt), (kj, kt), (vj, vt) = map(bf16_pair, (q, k, v))
    got = flash_attention_plain(qt, kt, vt, causal=causal, q_chunk=128,
                                kv_chunk=128)
    assert got.dtype == torch.bfloat16
    jnp_out = JA.flash_attention_jnp(qj, kj, vj, causal=causal, q_chunk=128,
                                     kv_chunk=128)
    assert_ulps(got, jnp_out)
    pallas = jfops.flash_attention(qj, kj, vj, causal=causal, qc=128, kc=128,
                                   interpret=True)
    assert np.abs(f32(got) - f32(pallas)).max() < 3e-2
    # the wrapper sends a CPU tensor to the plain version
    assert torch.equal(fops.flash_attention(qt, kt, vt, causal=causal,
                                            qc=128, kc=128), got)


def test_reference_attention_is_grouped_like_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 24, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 2, 32)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        f32(reference_attention(*map(torch.from_numpy, (q, k, v)))),
        f32(JA.reference_attention(*map(jnp.asarray, (q, k, v)))),
        atol=2e-6)


# ---------------------------------------------------------- ssd scan (plain)
def _ssd_np(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(np.float32)
    B = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    D = np.ones((h,), np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("s,chunk", [(128, 64), (256, 128), (192, 64)])
@pytest.mark.parametrize("p,n", [(32, 16), (64, 32)])
def test_ssd_plain_matches_jax(s, chunk, p, n):
    args = _ssd_np(2, s, 3, p, n, s + p)
    y, final = ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    jy, jfinal = JS.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    # y is bf16 in both; the fp32 state differs by summation order only
    assert_ulps(y, jy)
    np.testing.assert_allclose(f32(final), f32(jfinal), rtol=1e-5,
                               atol=1e-5 * np.abs(f32(jfinal)).max())
    # against the Pallas kernel (fp32 y) and the step-by-step oracle: the
    # tolerance of tests/test_kernels.py
    pallas = jsops.ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                            interpret=True)
    assert np.abs(f32(y) - f32(pallas)).max() < 5e-2
    _, rfinal = ssd_recurrent_reference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(f32(final), f32(rfinal), rtol=1e-4,
                               atol=1e-4 * np.abs(f32(rfinal)).max())
    yw, fw = sops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert torch.equal(yw, y) and torch.equal(fw, final)


def test_ssd_padded_wrapper_keeps_the_final_state():
    """s = 200 runs as 4 chunks of 64 with 56 zero steps: the final state
    equals the unpadded scan's (chunk 40 divides 200) within fp32
    rounding, since a zero dt neither decays nor updates it."""
    args = _ssd_np(2, 200, 3, 32, 16, 7)
    y, final = sops.ssd_scan(*map(torch.from_numpy, args), chunk=64)
    y40, final40 = ssd_chunked(*map(torch.from_numpy, args), chunk=40)
    assert y.shape == (2, 200, 3, 32)
    np.testing.assert_allclose(f32(final), f32(final40), rtol=1e-5,
                               atol=1e-5 * np.abs(f32(final40)).max())
    assert_ulps(y, y40, ulps=2)
    with pytest.raises(ValueError, match="not divisible"):
        JS.ssd_chunked(*map(jnp.asarray, args), chunk=64)
