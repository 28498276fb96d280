"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; each test skips where no CUDA device is visible.
Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import torch.nn.functional as F

from repro_torch.core.compression import byte_shuffle
from repro_torch.kernels.bitshuffle import ops as bops
from repro_torch.kernels.deposit import ops as dops
from repro_torch.kernels.deposit.ref import deposit_ref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (flash_attention_plain,
                                                     reference_attention)
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda:0")


def test_deposit_kernel_matches_plain_version(cuda_device):
    rng = np.random.default_rng(3)
    n, n_cells = 1 << 20, 100_000
    dx = 1.0 / n_cells
    x = rng.uniform(0, 1, n).astype(np.float32)
    x[:3] = [0.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0.0))]
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    alive = (rng.uniform(0, 1, n) > 0.25).astype(np.float32)
    tx, tw, ta = (torch.from_numpy(a).to(cuda_device) for a in (x, w, alive))
    before = dops.deposit.launches
    got = dops.deposit(tx, tw, ta, n_cells=n_cells, dx=dx)
    assert dops.deposit.launches == before + 1
    ref = deposit_ref(tx, tw, ta, n_cells, dx)
    # atomic order varies: agreement within fp32 rounding, not bitwise
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-4
    total = float((tw * ta).double().sum())
    assert abs(float(got.double().sum()) * dx - total) / total < 1e-5
    with pytest.raises(TypeError):
        dops.deposit(tx.double(), tw, ta, n_cells=n_cells, dx=dx)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("n_items", [1, 7, 65521, 262144])
def test_shuffle_kernels_are_bit_exact(cuda_device, itemsize, n_items):
    rng = np.random.default_rng(itemsize * 7 + n_items)
    raw = rng.integers(0, 256, n_items * itemsize, dtype=np.uint8)
    t = torch.from_numpy(raw).to(cuda_device)
    got = bops.shuffle_block(t, itemsize=itemsize).cpu().numpy()
    assert got.tobytes() == byte_shuffle(raw.tobytes(), itemsize)
    out, n = bops.shuffle(t, itemsize=itemsize)
    cpu_out, _ = bops.shuffle(t.cpu(), itemsize=itemsize)
    assert torch.equal(out.cpu(), cpu_out)
    assert torch.equal(bops.unshuffle(out, n, itemsize=itemsize), t)


# a leaf shorter than one block, an exact multiple, a ragged last block,
# a last block that is not a multiple of the item size, blocks that are
# not (999), and the write path's 1 MiB blocks with a ragged tail
@pytest.mark.parametrize("itemsize", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_bytes,block", [
    (1000, 4096), (3 * 4096, 4096), (3 * 4096 + 1000, 4096),
    (3 * 4096 + 6, 4096), (10_000, 999), (3 * (1 << 20) + 8 * 77, 1 << 20)])
def test_shuffle_blocks_kernel_is_bit_exact(cuda_device, itemsize, n_bytes,
                                            block):
    rng = np.random.default_rng(itemsize * 31 + n_bytes)
    raw = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    t = torch.from_numpy(raw).to(cuda_device)
    before = bops.shuffle_blocks.launches
    got = bops.shuffle_blocks(t, block=block, itemsize=itemsize)
    assert bops.shuffle_blocks.launches == before + 1
    host = b"".join(byte_shuffle(raw[i:i + block].tobytes(), itemsize)
                    for i in range(0, n_bytes, block))
    assert got.cpu().numpy().tobytes() == host
    plain = bops.shuffle_blocks(t.cpu(), block=block, itemsize=itemsize)
    assert torch.equal(got.cpu(), plain)
    # a start that is not 16-byte aligned takes the kernel's scalar path
    odd = bops.shuffle_blocks(t[1:], block=block, itemsize=itemsize)
    assert odd.cpu().numpy().tobytes() == b"".join(
        byte_shuffle(raw[1:][i:i + block].tobytes(), itemsize)
        for i in range(0, n_bytes - 1, block))


# bf16 outputs of two fp32 computations that round p and sum in other
# orders: one or two bf16 ulps of values up to ~4 (tests/test_kernels.py
# holds the TPU kernel to the same 3e-2 in bf16)
FLASH_TOL = 3e-2


@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [256, 200])
def test_flash_kernel_matches_plain_version(cuda_device, D, causal, S):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(D * 1000 + S + causal)
    B, H = 2, 3
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    before = fops.flash_attention.launches
    got = fops.flash_attention(q, k, v, causal=causal)
    assert fops.flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, causal=causal, q_chunk=512,
                                  kv_chunk=512)
    ref = reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    assert float((got.float() - plain.float()).abs().max()) < FLASH_TOL
    assert float((got.float() - ref.float()).abs().max()) < FLASH_TOL


def _flash_against_plain(dev, B, Sq, Skv, H, D, causal, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, Skv, H, D), generator=g, device=dev).bfloat16()
            for _ in range(2))
    got = fops.flash_attention(q, k, v, causal=causal)
    plain = flash_attention_plain(q, k, v, causal=causal, q_chunk=512,
                                  kv_chunk=512)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, Sq, H, D)
    assert torch.isfinite(got.float()).all()
    return float((got.float() - plain.float()).abs().max())


@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("S", [1, 65, 200, 512])
def test_flash_kernel_at_one_ragged_and_full_tiles(cuda_device, D, S):
    assert _flash_against_plain(cuda_device, 2, S, S, 3, D, True,
                                D + S) < FLASH_TOL


@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("Sq,Skv,causal", [(100, 300, False),
                                           (300, 70, False),
                                           (130, 260, True)])
def test_flash_kernel_with_other_key_lengths(cuda_device, D, Sq, Skv,
                                             causal):
    assert _flash_against_plain(cuda_device, 2, Sq, Skv, 3, D, causal,
                                D + Sq + Skv) < FLASH_TOL


def test_flash_kernel_reads_strided_inputs_and_rejects_others(cuda_device):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(5)
    B, S, H, D = 2, 192, 4, 80
    qkv = torch.randn((B, S, 3, H, D), generator=g,
                      device=cuda_device).bfloat16()
    q, k, v = qkv.unbind(2)                     # strided views, no copies
    got = fops.flash_attention(q, k, v)
    plain = flash_attention_plain(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    assert float((got.float() - plain.float()).abs().max()) < FLASH_TOL
    with pytest.raises(TypeError):
        fops.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 8, 1, 48), dtype=torch.bfloat16,
                        device=cuda_device)
        fops.flash_attention(x, x, x)


def _ssd_inputs(dev, b, s, h, p, n, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=dev).bfloat16()
    dt = F.softplus(torch.randn((b, s, h), generator=g, device=dev) - 1.0)
    # zamba2's A: -exp(linspace(log 1, log 16)); cs reaches about -200 in a
    # chunk, where exp(cs_l)/exp(cs_s) would underflow
    A = -torch.exp(torch.linspace(0.0, 2.772588722, h, device=dev))
    B = (torch.randn((b, s, n), generator=g, device=dev) * 0.3).bfloat16()
    C = (torch.randn((b, s, n), generator=g, device=dev) * 0.3).bfloat16()
    D = torch.ones((h,), device=dev)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("p,n", [(32, 16), (64, 64), (64, 128)])
@pytest.mark.parametrize("s", [256, 200])
def test_ssd_kernel_matches_plain_version(cuda_device, p, n, s):
    b, h, chunk = 2, 5, 128
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, b, s, h, p, n, p + n + s)
    before = sops.ssd_scan.launches
    y, final = sops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    assert sops.ssd_scan.launches == before + 1
    pad = (-s) % chunk                # the plain version needs whole chunks
    yr, fr = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                         F.pad(dt, (0, 0, 0, pad)), A,
                         F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)),
                         D, chunk=chunk)
    torch.cuda.synchronize()
    assert y.shape == (b, s, h, p) and y.dtype == torch.bfloat16
    assert final.shape == (b, h, p, n) and final.dtype == torch.float32
    # y: bf16 of fp32 sums taken in another order (one or two ulps);
    # the fp32 state: relative rounding of sums over a whole sequence
    assert float((y.float() - yr[:, :s].float()).abs().max()) < 5e-2
    scale = max(1.0, float(fr.abs().max()))
    assert float((final - fr).abs().max()) < 1e-4 * scale


def test_ssd_kernel_carries_an_initial_state(cuda_device):
    b, s, h, p, n = 2, 256, 4, 64, 64
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, b, s, h, p, n, 11)
    y_all, f_all = sops.ssd_scan(x, dt, A, B, C, D)
    first, second = ([t[:, half].contiguous() for t in (x, dt, B, C)]
                     for half in (slice(0, 128), slice(128, None)))
    _, f_half = sops.ssd_scan(first[0], first[1], A, first[2], first[3], D)
    y2, f2 = sops.ssd_scan(second[0], second[1], A, second[2], second[3], D,
                           initial_state=f_half)
    torch.cuda.synchronize()
    assert float((y2.float() - y_all[:, 128:].float()).abs().max()) < 5e-2
    assert float((f2 - f_all).abs().max()) < 1e-4 * max(
        1.0, float(f_all.abs().max()))
