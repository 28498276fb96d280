"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; each test skips where no CUDA device is visible.
Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

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
from repro_torch.kernels.spawn import ops as spops
from repro_torch.kernels.spawn.ref import spawn_ref
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


def flash_err(got, ref):
    """max |got - ref| over its limit: two bf16 ulps of max |ref|, and
    never more than FLASH_TOL (grown above values of 4 as an ulp does).
    An output that averages many keys is small, so a limit fixed for
    values up to 4 would let a wrong kernel through."""
    err = float((got.float() - ref.float()).abs().max())
    top = float(ref.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7)
    return err / min(FLASH_TOL * max(1.0, top / 4), 2 * ulp)


@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
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
    assert flash_err(got, plain) <= 1
    assert flash_err(got, ref) <= 1


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
    return flash_err(got, plain)


@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("S", [1, 65, 200, 512])
def test_flash_kernel_at_one_ragged_and_full_tiles(cuda_device, D, S):
    assert _flash_against_plain(cuda_device, 2, S, S, 3, D, True,
                                D + S) <= 1


@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("Sq,Skv,causal", [(100, 300, False),
                                           (300, 70, False),
                                           (130, 260, True)])
def test_flash_kernel_with_other_key_lengths(cuda_device, D, Sq, Skv,
                                             causal):
    assert _flash_against_plain(cuda_device, 2, Sq, Skv, 3, D, causal,
                                D + Sq + Skv) <= 1


@pytest.mark.parametrize("B,Sq,Skv,H,causal", [
    (4, 512, 512, 16, True),       # deepseek-moe-16b's attention
    (4, 512, 512, 64, True),       # llama-3.2-vision-90b's self layers
    (4, 512, 1600, 64, False)])    # its cross layers over 1600 image tokens
def test_flash_kernel_at_the_moe_and_vlm_serving_shapes(cuda_device, B, Sq,
                                                        Skv, H, causal):
    assert _flash_against_plain(cuda_device, B, Sq, Skv, H, 128, causal,
                                H + Skv) <= 1


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
    assert flash_err(got, plain) <= 1
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


# ---- the redesigned kernels: the SSD scan's p slices, partial chunks and
# split state; the deposit's cluster and global paths

def _ssd_check(dev, b, s, h, p, n, seed, initial=False):
    x, dt, A, B, C, D = _ssd_inputs(dev, b, s, h, p, n, seed)
    init = None
    if initial:
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 1)
        init = torch.randn((b, h, p, n), generator=g, device=dev)
    before = sops.ssd_scan.launches
    y, final = sops.ssd_scan(x, dt, A, B, C, D, initial_state=init)
    assert sops.ssd_scan.launches == before + 1     # two kernels, one call
    chunk = min(128, s)
    pad = (-s) % chunk
    yr, fr = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                         F.pad(dt, (0, 0, 0, pad)), A,
                         F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)),
                         D, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert y.shape == (b, s, h, p) and final.shape == (b, h, p, n)
    assert torch.isfinite(y.float()).all() and torch.isfinite(final).all()
    assert float((y.float() - yr[:, :s].float()).abs().max()) < 5e-2
    scale = max(1.0, float(fr.abs().max()))
    assert float((final - fr).abs().max()) < 1e-4 * scale


# h = 7: no head count is special to the kernel (one head a block, C.B^T
# shared by all heads of a batch); p = 32 is one p slice, p = 64 two
@pytest.mark.parametrize("p", [32, 64])
@pytest.mark.parametrize("n", [64, 128])
def test_ssd_kernel_at_odd_heads_and_p_slices(cuda_device, p, n):
    _ssd_check(cuda_device, 2, 256, 7, p, n, 100 * p + n)


# s = 1 and 127: one chunk shorter than a 16-row tile or than 128; s = 129:
# a whole chunk and one step; s = 512: the prefill's four chunks
@pytest.mark.parametrize("s", [1, 127, 129, 512])
@pytest.mark.parametrize("initial", [False, True])
def test_ssd_kernel_at_partial_chunks(cuda_device, s, initial):
    _ssd_check(cuda_device, 2, s, 5, 64, 64, s + 7 * initial, initial)


@pytest.mark.parametrize("s", [256, 200])
def test_ssd_kernel_split_state_equals_one_scan(cuda_device, s):
    """Scanning s in two halves, the second from the first's final state,
    gives the one scan's y and final state."""
    b, h, p, n = 2, 5, 64, 64
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, b, s, h, p, n, 31 + s)
    y_all, f_all = sops.ssd_scan(x, dt, A, B, C, D)
    cut = s // 2
    first, second = ([t[:, part].contiguous() for t in (x, dt, B, C)]
                     for part in (slice(0, cut), slice(cut, None)))
    y1, f1 = sops.ssd_scan(first[0], first[1], A, first[2], first[3], D)
    y2, f2 = sops.ssd_scan(second[0], second[1], A, second[2], second[3], D,
                           initial_state=f1)
    torch.cuda.synchronize()
    y = torch.cat([y1, y2], 1)
    assert float((y.float() - y_all.float()).abs().max()) < 5e-2
    assert float((f2 - f_all).abs().max()) < 1e-4 * max(
        1.0, float(f_all.abs().max()))


def test_ssd_kernel_takes_inputs_that_start_off_16_bytes(cuda_device):
    """x, B and C as contiguous views 2 bytes into their storage: the
    wrapper copies them to aligned memory for the kernel's 16-byte
    copies, and the result is the aligned call's."""
    args = _ssd_inputs(cuda_device, 2, 256, 5, 64, 64, 23)

    def shifted(t):
        flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
        return flat[1:].view(t.shape)

    x, dt, A, B, C, D = args
    odd = (shifted(x), dt, A, shifted(B), shifted(C), D)
    assert all(t.data_ptr() % 16 for t in (odd[0], odd[3], odd[4]))
    y, final = sops.ssd_scan(*args)
    y_odd, final_odd = sops.ssd_scan(*odd)
    torch.cuda.synchronize()
    assert torch.equal(y, y_odd) and torch.equal(final, final_odd)


def test_ssd_kernel_matches_its_rounding_reference(cuda_device):
    """Against `ssd_chunked_split`, the plain version with the kernel's
    bf16 hi/lo operands, at the prefill's chunking."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_split
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, 2, 512, 6, 64, 64, 5)
    y, final = sops.ssd_scan(x, dt, A, B, C, D)
    ys, fs = ssd_chunked_split(x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert float((y.float() - ys.float()).abs().max()) < 5e-2
    assert float((final - fs).abs().max()) < 1e-4 * max(
        1.0, float(fs.abs().max()))


def _deposit_case(dev, n, n_cells, seed, *, dead=False, offset=0):
    rng = np.random.default_rng(seed)
    dx = 1.0 / n_cells
    m = n + offset
    x = rng.uniform(0, 1, m).astype(np.float32)
    x[:3] = [0.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0.0))]
    w = rng.uniform(0.5, 2.0, m).astype(np.float32)
    alive = (np.zeros(m) if dead else
             rng.uniform(0, 1, m) > 0.25).astype(np.float32)
    tx, tw, ta = (torch.from_numpy(a).to(dev)[offset:]
                  for a in (x, w, alive))
    got = dops.deposit(tx, tw, ta, n_cells=n_cells, dx=dx)
    ref = deposit_ref(tx, tw, ta, n_cells, dx)
    torch.cuda.synchronize()
    return got, ref, tx, tw, ta, dx


def _assert_deposit(got, ref, tw, ta, dx):
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-4
    total = float((tw * ta).double().sum())
    assert abs(float(got.double().sum()) * dx - total) / total < 1e-5


@pytest.mark.parametrize("over", [False, True])
def test_deposit_kernel_on_both_sides_of_the_cluster_limit(cuda_device,
                                                           over):
    limit = dops.cluster_cell_limit()
    n_cells = limit + 1 if over else limit - 1
    got, ref, _, tw, ta, dx = _deposit_case(cuda_device, 1 << 20, n_cells,
                                            int(over))
    assert dops.deposit.last_path == ("global" if over else "cluster")
    _assert_deposit(got, ref, tw, ta, dx)


# N not a multiple of 4 (the scalar tail), and a start 4 bytes past the
# 16-byte alignment (scalar loads throughout), on both paths
@pytest.mark.parametrize("n,offset", [((1 << 20) + 3, 0), (1 << 20, 1),
                                      (4097, 1)])
@pytest.mark.parametrize("n_cells", [100_000, 300_000])
def test_deposit_kernel_ragged_and_unaligned(cuda_device, n, offset,
                                            n_cells):
    got, ref, tx, tw, ta, dx = _deposit_case(cuda_device, n, n_cells,
                                             n + offset, offset=offset)
    assert tx.shape == (n,)
    _assert_deposit(got, ref, tw, ta, dx)


@pytest.mark.parametrize("n_cells", [100_000, 300_000])
def test_deposit_kernel_with_all_particles_dead(cuda_device, n_cells):
    got, _, _, _, _, _ = _deposit_case(cuda_device, 1 << 16, n_cells, 9,
                                       dead=True)
    assert torch.equal(got, torch.zeros_like(got))


def test_deposit_kernel_conserves_charge_at_the_paper_grid(cuda_device):
    got, ref, _, tw, ta, dx = _deposit_case(cuda_device, 1 << 22, 100_000,
                                            17)
    assert dops.deposit.last_path == "cluster"
    _assert_deposit(got, ref, tw, ta, dx)


# ------------------------------------------------------------- spawn
def _spawn_inputs(dev, C, M, n_dead, n_events, seed, *, tail=False,
                  offset=0):
    """A species of C slots with n_dead dead (scattered, or the last ones)
    and M candidates with n_events events, on `dev`; `offset` floats into
    each buffer, so a start off the 16-byte alignment takes scalar loads."""
    rng = np.random.default_rng(seed)
    alive = np.ones(C, np.float32)
    alive[np.arange(C - n_dead, C) if tail else
          rng.permutation(C)[:n_dead]] = 0.0
    mask = np.zeros(M, bool)
    mask[rng.permutation(M)[:n_events]] = True
    arrays = (rng.uniform(0, 1, C), rng.normal(size=(C, 3)),
              rng.uniform(0.5, 1.5, C), alive, rng.uniform(0, 1, M),
              rng.normal(size=(M, 3)), rng.uniform(0.5, 1.5, M), mask)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if not offset:
            return t
        flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=dev)
        flat[offset:] = t.reshape(-1)
        return flat[offset:].view(t.shape)
    return [put(a.astype(np.float32) if a.dtype != bool else a)
            for a in arrays]


def _assert_spawn_bit_exact(args, launches=4):
    before = spops.spawn.launches
    got = spops.spawn(*args)
    assert spops.spawn.launches == before + launches
    ref = spawn_ref(*args)
    for name, g, r in zip(("x", "v", "w", "alive"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert torch.equal(g.view(torch.int32), r.view(torch.int32)), name
    assert got[4].dtype == torch.int64 and got[4].shape == ()
    assert int(got[4]) == int(ref[4])
    return got


# events under, at and over the dead count; no event, no dead slot, all
# dead; capacities that are not a multiple of the 4096-slot tile, up to
# 2^22 + 7; fewer and more candidates than slots; dead slots at the tail
@pytest.mark.parametrize("C,M,n_dead,n_events,tail", [
    (1 << 16, 1 << 16, 5000, 300, False),
    (1 << 16, 1 << 16, 4000, 4000, False),
    (1 << 16, 1 << 16, 300, 5000, False),
    (1 << 16, 1 << 16, 5000, 0, False),
    (1 << 16, 1 << 16, 0, 100, False),
    (1 << 16, 1 << 16, 1 << 16, 700, False),
    (1 << 16, 1 << 16, 1 << 16, 1 << 16, False),
    (4097, 4097, 2000, 1500, False),
    (4095, 9001, 4000, 9001, False),
    (12291, 5, 6000, 5, False),
    ((1 << 22) + 7, (1 << 22) + 7, 1 << 21, 300_000, False),
    ((1 << 22) + 7, (1 << 22) + 7, 3_000_000, 3_500_000, True),
    (1 << 20, 1 << 20, 600_000, 40_000, True)])
def test_spawn_kernel_is_bit_exact(cuda_device, C, M, n_dead, n_events,
                                   tail):
    args = _spawn_inputs(cuda_device, C, M, n_dead, n_events,
                         C + n_dead + n_events, tail=tail)
    _assert_spawn_bit_exact(args)


# C or M of 0: the fill or the compaction has no tile to launch
@pytest.mark.parametrize("C,M,launches", [(0, 4096, 3), (4096, 0, 3),
                                          (0, 0, 1)])
def test_spawn_kernel_with_no_slot_or_no_candidate(cuda_device, C, M,
                                                   launches):
    args = _spawn_inputs(cuda_device, C, M, C // 2, M // 2, 5)
    if C:
        got = _assert_spawn_bit_exact(args, launches)
    else:   # the plain version indexes an empty sort: every event dropped
        before = spops.spawn.launches
        got = spops.spawn(*args)
        assert spops.spawn.launches == before + launches
        assert [t.shape for t in got[:4]] == [(0,), (0, 3), (0,), (0,)]
    assert int(got[4]) == (M // 2 if C == 0 else 0)


# starts 4 bytes past the 16-byte alignment: scalar accesses throughout
@pytest.mark.parametrize("C", [1 << 16, 70_001])
def test_spawn_kernel_unaligned(cuda_device, C):
    args = _spawn_inputs(cuda_device, C, C, C // 3, C // 5, 11, offset=1)
    assert all(t.data_ptr() % 16 for t in args[:4])
    _assert_spawn_bit_exact(args)


def test_spawn_kernel_after_absorbing_walls(cuda_device):
    """Dead slots scattered as the walls leave them, through
    `particles.spawn` (the kernel) against the plain version."""
    from repro_torch.pic import particles
    C = 1 << 20
    g = torch.Generator(device=cuda_device).manual_seed(4)
    sp = particles.init_species(g, C, C - 1000, L=1.0, v_thermal=40.0,
                                charge=-1.0, mass=1.0, device=cuda_device)
    sp, wall = particles.push(sp, torch.zeros_like(sp.x), 1e-3, 1.0,
                              boundary="absorbing")
    n_dead = int((sp.alive <= 0).sum())
    assert float(wall) > 0 and n_dead > 20_000
    gone = torch.nonzero(sp.alive[:C - 1000] <= 0)
    assert gone.numel() > 0.5 * n_dead  # not only the tail
    new_x = torch.rand(C, generator=g, device=cuda_device)
    new_v = torch.randn(C, 3, generator=g, device=cuda_device)
    new_w = torch.rand(C, generator=g, device=cuda_device)
    mask = torch.rand(C, generator=g, device=cuda_device) < 0.015
    before = spops.spawn.launches
    out, dropped = particles.spawn(sp, new_x, new_v, new_w, mask)
    assert spops.spawn.launches == before + 4
    ref = spawn_ref(sp.x, sp.v, sp.w, sp.alive, new_x, new_v, new_w, mask)
    for g_, r in zip((out.x, out.v, out.w, out.alive), ref):
        assert torch.equal(g_.view(torch.int32), r.view(torch.int32))
    assert int(dropped) == int(ref[4]) == max(int(mask.sum()) - n_dead, 0)


def test_spawn_kernel_makes_no_host_sync(cuda_device):
    args = _spawn_inputs(cuda_device, 1 << 20, 1 << 20, 1 << 19, 20_000, 6)
    spops.spawn(*args)                   # the first call builds and loads
    torch.cuda.synchronize()
    before = spops.spawn.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            out = spops.spawn(*args)
        # the mode sees the plain version's sync (a host scalar to the card)
        with pytest.raises(RuntimeError):
            spawn_ref(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert spops.spawn.launches == before + 3 * 4
    assert torch.equal(out[3], spawn_ref(*args)[3])


def test_spawn_wrapper_refuses_what_the_kernel_does_not_take(cuda_device,
                                                             monkeypatch):
    args = _spawn_inputs(cuda_device, 4096, 4096, 100, 50, 8)
    x, v, w, alive, nx, nv, nw, mask = args
    with pytest.raises(TypeError):
        spops.spawn(x.double(), v, w, alive, nx, nv, nw, mask)
    with pytest.raises(TypeError):
        spops.spawn(x, v, w, alive, nx, nv, nw, mask.to(torch.uint8))
    with pytest.raises(ValueError):   # not contiguous
        spops.spawn(x, v.t().contiguous().t(), w, alive, nx, nv, nw, mask)
    with pytest.raises(ValueError):   # on another device
        spops.spawn(x, v, w, alive.cpu(), nx, nv, nw, mask)
    with pytest.raises(ValueError):   # shapes
        spops.spawn(x, v, w, alive, nx[:-1], nv, nw, mask)
    monkeypatch.setattr(spops, "_LIMIT", 4096)
    with pytest.raises(ValueError):   # C or M of 2**31 or more
        spops.spawn(*args)


# ------------------------------------------------- moe and cross blocks
def _block_case(name, seed):
    """A smoke config's params and a bf16 input on the CPU (head_dim 32,
    which the kernel takes); vlm gates at 1.0 and no-drop MoE capacity."""
    import dataclasses
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.models import model as M
    cfg = reduce_for_smoke(get_config(name))
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = M.init_params(cfg, seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 96, cfg.d_model), generator=g).bfloat16()
    pos = torch.arange(96, dtype=torch.int32)[None].expand(2, 96)
    return cfg, params, x, pos


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _ulps(got, ref):
    """max |got - ref| in bf16 ulps of max |ref|."""
    return float((got.float().cpu() - ref.float()).abs().max()
                 / (ref.float().abs().max() * 2.0 ** -7))


def test_moe_block_on_the_card_matches_the_cpu(cuda_device):
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import attention_block
    from repro_torch.models.layers import rms_norm
    cfg, params, x, pos = _block_case("deepseek-moe-16b", 11)
    lp = params["stack"]["layers"][0]
    glp, gx, gpos = _on(lp, cuda_device), x.to(cuda_device), pos.to(
        cuda_device)
    before = fops.flash_attention.launches
    y, (k, v), aux = T.moe_block_seq(glp, gx, cfg, gpos, 32, 32)
    assert fops.flash_attention.launches == before + 1
    ry, (rk, rv), raux = T.moe_block_seq(lp, x, cfg, pos, 32, 32)
    assert _ulps(k, rk) <= 1 and _ulps(v, rv) <= 1
    # the kernel's attention rounds apart from the plain version's by a
    # bf16 ulp here and there; where that moves a token's top-k choice its
    # MoE output differs outright, so such tokens are counted, not compared
    def top_e(p, x, pos):
        h, _ = attention_block(p["attn"], rms_norm(p["attn_norm"], x,
                                                   cfg.norm_eps),
                               cfg=cfg, positions=pos, q_chunk=32,
                               kv_chunk=32)
        return moe.route(p["moe"], rms_norm(p["ffn_norm"], x + h,
                                            cfg.norm_eps), cfg)[2]
    same = (top_e(glp, gx, gpos).cpu() == top_e(lp, x, pos)).all(-1)
    assert float(same.float().mean()) >= 15 / 16
    assert _ulps(y.cpu()[same], ry[same]) <= 4
    assert abs(float(aux) - float(raux)) < 1e-2 * float(raux)
    # the MoE FFN alone on one input: the same routing and drops on both
    h = torch.randn((2, 96, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3)).bfloat16()
    mp, gmp = lp["moe"], glp["moe"]
    te, re = moe.route(gmp, h.to(cuda_device), cfg)[2], moe.route(mp, h,
                                                                   cfg)[2]
    assert torch.equal(te.cpu(), re)
    gy, _ = moe.moe_ffn(gmp, h.to(cuda_device), cfg)
    ry, _ = moe.moe_ffn(mp, h, cfg)
    assert _ulps(gy, ry) <= 2


def test_moe_ffn_with_capacity_drops_on_the_card_matches_the_cpu(
        cuda_device):
    # as tests/test_torch_moe.py's drop case: C = 8 slots an expert for 128
    # assignments a group over 8 experts, so dispatch sends drops to the
    # overflow row and gathers its zeros back
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=64,
                      n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=64,
                      n_experts=8, top_k=2, capacity_factor=0.25,
                      n_shared_experts=1)
    p = moe.init_moe(torch.Generator().manual_seed(21), cfg,
                     device=torch.device("cpu"))
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(22)).bfloat16()
    gp, gx = _on(p, cuda_device), x.to(cuda_device)
    C = moe._capacity(64, cfg)
    probs, _, te = moe.route(gp, gx, cfg)
    _, _, re = moe.route(p, x, cfg)
    s = probs.sort(-1, descending=True).values
    gap = float((s[..., 1] - s[..., 2]).min())
    assert torch.equal(te.cpu(), re), f"smallest k-th gap {gap:.3g}"
    gv, rv = moe.dispatch(te, 8, C)[2], moe.dispatch(re, 8, C)[2]
    assert torch.equal(gv.cpu(), rv) and int((~rv).sum()) > 0
    gy, gaux = moe.moe_ffn(gp, gx, cfg)
    ry, raux = moe.moe_ffn(p, x, cfg)
    assert _ulps(gy, ry) <= 2
    assert abs(float(gaux) - float(raux)) <= 1e-5 * float(raux)


def test_cross_block_on_the_card_matches_the_cpu(cuda_device):
    from repro_torch.models import transformer as T
    cfg, params, x, pos = _block_case("llama-3.2-vision-90b", 12)
    cp = params["stack"]["cross"][0]
    cp["attn_gate"] = torch.ones_like(cp["attn_gate"])
    cp["ffn_gate"] = torch.ones_like(cp["ffn_gate"])
    vision = torch.randn((2, 160, cfg.d_model), generator=torch.Generator()
                         .manual_seed(5)).bfloat16()
    before = fops.flash_attention.launches
    y, (k, v) = T.cross_block_seq(_on(cp, cuda_device), x.to(cuda_device),
                                  vision.to(cuda_device), cfg,
                                  pos.to(cuda_device))
    assert fops.flash_attention.launches == before + 1
    ry, (rk, rv) = T.cross_block_seq(cp, x, vision, cfg, pos)
    assert _ulps(k, rk) <= 1 and _ulps(v, rv) <= 1
    assert _ulps(y, ry) <= 4
    u = x[:, :1]
    gy = T.cross_block_step(_on(cp, cuda_device), u.to(cuda_device), k, v,
                            cfg)
    ry = T.cross_block_step(cp, u, rk, rv, cfg)
    assert _ulps(gy, ry) <= 4



def _chunk_payloads(path):
    """{(variable, rank, offset): payload bytes} of a checkpoint's step."""
    from repro_torch.core.bp_engine import BpReader
    out = {}
    with BpReader(path) as r:
        (step,) = r.valid_steps()
        for name in r.var_names(step):
            for ch in r.iter_chunks(step, name):
                out[(name, ch.rank, ch.offset)] = r._read_payload(
                    ch.agg, ch.file_offset, ch.nbytes)
    return out


def test_parallel_device_checkpoint_payloads_equal_the_serial_engines(
        cuda_device, tmp_path):
    """CUDA tensor leaves saved with device_compress through 4 writer
    processes (shuffled by the coordinator's kernel, pre-shuffled bytes to
    the workers) give the serial engine's payloads, chunk for chunk, and
    restore bit for bit on the card."""
    from repro_torch.ckpt.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.core.bp_engine import EngineConfig
    from repro_torch.core.darshan import CTR, MONITOR
    g = torch.Generator(device=cuda_device)
    g.manual_seed(16)
    state = {"x": torch.rand((3 << 19) + 5, generator=g, device=cuda_device),
             "v": torch.randn((1 << 18, 3), generator=g, device=cuda_device),
             "alive": (torch.rand(1 << 20, generator=g, device=cuda_device)
                       > 0.3).float(),
             "key": torch.tensor([7, 9], dtype=torch.uint32,
                                 device=cuda_device),
             "step": torch.tensor(4, dtype=torch.int32, device=cuda_device),
             "charge": -1.0}
    cfg = EngineConfig(aggregators=4, codec="blosc")
    shuffled = {}
    for which, kw in (("serial", {}), ("parallel", {"parallel_io": 4})):
        MONITOR.reset()
        before = bops.shuffle_blocks.launches
        save_checkpoint(tmp_path / which, state, 4, n_io_ranks=16,
                        engine_config=cfg, device_compress=True, **kw)
        shuffled[which] = (bops.shuffle_blocks.launches - before,
                           MONITOR.report()["total"].get(
                               CTR.COMPRESS_DEVICE_BYTES, 0))
        back, _ = restore_checkpoint(tmp_path / which, state)
        for k, v in state.items():
            if isinstance(v, torch.Tensor):
                assert back[k].device == v.device and torch.equal(back[k], v)
    nbytes = sum(state[k].numel() * state[k].element_size()
                 for k in ("x", "v", "alive", "key"))
    # one launch a row chunk: x, v, alive in 16, the key (2 rows) in 2
    assert shuffled["serial"] == shuffled["parallel"] == (3 * 16 + 2, nbytes)
    serial = _chunk_payloads(tmp_path / "serial" / "step_00000004.bp4")
    parallel = _chunk_payloads(tmp_path / "parallel" / "step_00000004.bp4")
    assert serial.keys() == parallel.keys()
    for key, payload in serial.items():
        assert parallel[key] == payload, key


def test_split_device_checkpoint_equals_the_host_path(cuda_device, tmp_path):
    """CUDA leaves are row-split by rank: the four aggregators' writer
    threads shuffle their rows on the card at once, one launch a chunk.
    The chunk table (rank, offset, extent, aggregator, min/max) equals the
    host path's, and so does every chunk's payload but the key's (one
    uint32 a chunk, stored raw, keeps FLAG_PRESHUFFLED on the device
    path); each subfile books its share of the shuffled bytes, and the
    checkpoint restores bit for bit."""
    from repro_torch.ckpt.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.core.bp_engine import BpReader, EngineConfig
    from repro_torch.core.darshan import CTR, MONITOR
    g = torch.Generator(device=cuda_device)
    g.manual_seed(30)
    n = 1 << 20
    state = {"x": torch.rand(n, generator=g, device=cuda_device),
             "v": torch.randn((n, 3), generator=g, device=cuda_device),
             "alive": (torch.rand(n, generator=g, device=cuda_device)
                       > 0.3).float(),
             "key": torch.tensor([7, 9], dtype=torch.uint32,
                                 device=cuda_device)}
    cfg = EngineConfig(aggregators=4, workers=4, codec="blosc")
    tables, booked = {}, {}
    for dev in (True, False):
        MONITOR.reset()
        before = bops.shuffle_blocks.launches
        path = save_checkpoint(tmp_path / str(dev), state, 2, n_io_ranks=4,
                               engine_config=cfg, device_compress=dev)
        if dev:
            assert bops.shuffle_blocks.launches - before == 3 * 4 + 2
            booked = {f.rsplit("/", 1)[-1]: c.get(CTR.COMPRESS_DEVICE_BYTES)
                      for f, c in MONITOR.report()["files"].items()
                      if "/data." in f}
        with BpReader(path) as r:
            tables[dev] = {
                name: sorted(((c.rank, c.offset, c.extent, c.agg),
                              (c.vmin, c.vmax),
                              r._read_payload(c.agg, c.file_offset,
                                              c.nbytes))
                             for c in r.iter_chunks(2, name))
                for name in r.var_names(2)}
        back, _ = restore_checkpoint(tmp_path / str(dev), state)
        for k, v in state.items():
            assert back[k].device == v.device and torch.equal(back[k], v)
    quarter = (4 + 12 + 4) * n // 4
    assert booked == {"data.0": quarter + 4, "data.1": quarter + 4,
                      "data.2": quarter, "data.3": quarter}
    assert [c[0] for c in tables[True]["state/key"]] == [
        (0, (0,), (1,), 0), (1, (1,), (1,), 1)]
    assert [c[:2] for c in tables[True]["state/key"]] == \
        [c[:2] for c in tables[False]["state/key"]]
    for name in ("state/x", "state/v", "state/alive"):
        assert len(tables[True][name]) == 4
        assert tables[True][name] == tables[False][name], name


def test_tools_read_a_device_compressed_checkpoint(cuda_device, tmp_path,
                                                   capsys):
    """The read side over a checkpoint of CUDA tensors saved with
    device_compress: jbpfsck --deep comes back clean and each block the
    shuffle kernel wrote is on disk as blosc (its decode unshuffles) or,
    where LZ did not pay, raw with FLAG_PRESHUFFLED; jbpls lists it with no
    data.* byte read; a jbpd box read equals the tensors on the card."""
    import json

    from repro_torch.ckpt.checkpoint import save_checkpoint
    from repro_torch.core import compression as C
    from repro_torch.core.bp_engine import BpReader, EngineConfig
    from repro_torch.core.darshan import MONITOR
    from repro_torch.serve.jbpd import JbpDaemon, SeriesClient, SeriesServer
    from repro_torch.tools import jbpfsck, jbpls
    g = torch.Generator(device=cuda_device)
    g.manual_seed(21)
    # each leaf is 4 row chunks at 4 I/O ranks, each chunk one block: the
    # noise's (768 KiB and 5 B more) do not compress, so they are shuffled
    # and stored raw; the ramp's (512 KiB) compress
    state = {"noise": torch.randint(-2 ** 31, 2 ** 31 - 1,
                                    ((3 << 18) + 5,), dtype=torch.int32,
                                    generator=g, device=cuda_device),
             "ramp": torch.arange(1 << 19, dtype=torch.float32,
                                  device=cuda_device).reshape(-1, 4) / 7}
    before = bops.shuffle_blocks.launches
    path = save_checkpoint(tmp_path / "ckpt", state, 3, n_io_ranks=4,
                           engine_config=EngineConfig(aggregators=2,
                                                      codec="blosc"),
                           device_compress=True)
    assert bops.shuffle_blocks.launches == before + 2 * 4
    assert jbpfsck.main([str(path), "--deep"]) == 0
    capsys.readouterr()
    kinds = {}
    with BpReader(path) as r:
        step = r.valid_steps()[-1]
        for name in state:
            kinds[name] = [
                (C.CODEC_NAMES[cid], bool(flags & C.FLAG_PRESHUFFLED))
                for ch in r.iter_chunks(step, f"state/{name}")
                for _o, cid, _i, flags, _r, _c in C.iter_block_headers(
                    r._read_payload(ch.agg, ch.file_offset, ch.nbytes))]
    assert kinds == {"noise": [("none", True)] * 4,
                     "ramp": [("blosc", False)] * 4}
    MONITOR.reset()
    assert jbpls.main([str(path), "-l", "-L", "--json"]) == 0
    listed = json.loads(capsys.readouterr().out)["variables"]
    assert set(listed) == {"state/noise", "state/ramp"}
    assert sum(c.get("POSIX_BYTES_READ", 0)
               for f, c in MONITOR.report()["files"].items()
               if "data." in f) == 0
    sock = tmp_path / "d.sock"
    with JbpDaemon(SeriesServer([path]), socket_path=sock).start() as d:
        with SeriesClient(d.address, path) as c:
            for name, off, ext in (("noise", (1000,), (600_000,)),
                                   ("ramp", (100, 0), (70_000, 4))):
                box = c.read_var(step, f"state/{name}", off, ext)
                sl = tuple(slice(o, o + e) for o, e in zip(off, ext))
                assert torch.equal(torch.from_numpy(box).to(cuda_device),
                                   state[name][sl])
            assert c.stats()["counters"]["SERVICE_SHM_BYTES"] > 0


# -------------------------------------------------------------------- training
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_lse_matches_plain_version(cuda_device, D, causal):
    """The kernel's lse (natural log-sum-exp of the scaled scores, fp32
    [B,H,S]) against the plain version's within 1e-3 (fp32 sums in
    another order; a log in base 2 or of unscaled scores is off by tens of
    percent); its output bit-equal to the serving call's (lse null)."""
    from repro_torch.kernels.flash_attention.ref import flash_fwd_plain
    g = torch.Generator(device=cuda_device)
    g.manual_seed(D + 7 * causal)
    B, S, H = 2, 200, 3
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    before = fops.flash_attention.launches
    out, lse = fops.flash_forward(q, k, v, causal=causal)
    assert fops.flash_attention.launches == before + 1
    ref, lref = flash_fwd_plain(q, k, v, causal=causal, q_chunk=256,
                                kv_chunk=256)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert float((lse - lref).abs().max()) < 1e-3
    assert flash_err(out, ref) <= 1
    assert torch.equal(out, fops.flash_attention(q, k, v, causal=causal))


def _flash_grads(q, k, v, do, fn, **kw):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    fn(q, k, v, **kw).backward(do)
    return q.grad, k.grad, v.grad


class _PlainForwardFlash(fops.FlashAttention):
    """The Function with the plain forward: the same backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, qc, kc):
        from repro_torch.kernels.flash_attention.ref import flash_fwd_plain
        out, lse = flash_fwd_plain(q, k, v, causal=causal, q_chunk=qc,
                                   kv_chunk=kc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, qc, kc)
        return out


@pytest.mark.parametrize("B,Sq,Skv,H,D,causal", [
    (2, 256, 256, 4, 80, True), (2, 256, 256, 4, 64, True),
    (2, 128, 320, 4, 128, False)])
def test_flash_gradients_kernel_forward_vs_plain_forward(
        cuda_device, B, Sq, Skv, H, D, causal):
    """Gradients through the autograd Function with the kernel's forward
    (out and lse) against the same Function with the plain forward, the
    backward being `flash_attention_bwd_plain` in both. The noise floor is
    the plain forward chunked two ways (128 and 64 rows): the kernel's
    gradients within 2 floors, or 2 bf16 ulps of their largest value."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(Sq + Skv + D)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn((B, Skv, H, D), generator=g, device=cuda_device)
            .bfloat16() for _ in range(2))
    do = torch.randn((B, Sq, H, D), generator=g,
                     device=cuda_device).bfloat16()
    kw = dict(causal=causal)

    def plain(qc):
        return lambda q, k, v, causal: _PlainForwardFlash.apply(
            q, k, v, causal, qc, qc)
    before = fops.flash_attention.launches
    got = _flash_grads(q, k, v, do, fops.flash_attention, qc=128, kc=128,
                       **kw)
    assert fops.flash_attention.launches == before + 1   # none backward
    ref = _flash_grads(q, k, v, do, plain(128), **kw)
    alt = _flash_grads(q, k, v, do, plain(64), **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, alt):
        err = float((a.float() - b.float()).abs().max())
        floor = float((c.float() - b.float()).abs().max())
        top = float(b.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7)
        assert err <= max(2 * floor, 2 * ulp), (err, floor, top)


@pytest.mark.parametrize("s", [256, 200])
def test_ssd_gradients_kernel_forward_vs_plain_forward(cuda_device, s):
    """At the trainer's chunk 64: the SsdScan Function (the kernel's
    forward; the backward recomputes the plain scan on the same padded
    inputs) against autograd of the plain scan: y within the forward
    checks' limit, every input's gradient equal within 1e-5 of its
    largest value (the same plain computation on the card)."""
    b, h, p, n, chunk = 2, 5, 64, 64, 64
    args = _ssd_inputs(cuda_device, b, s, h, p, n, s + 3)
    dy = torch.randn((b, s, h, p), device=cuda_device).bfloat16()

    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in args]
        y, _ = fn(*ins)
        y.backward(dy)
        return y.detach(), [t.grad for t in ins]

    def plain(x, dt, A, B, C, D):
        pad = (-s) % chunk
        y, f = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                           F.pad(dt, (0, 0, 0, pad)), A,
                           F.pad(B, (0, 0, 0, pad)),
                           F.pad(C, (0, 0, 0, pad)), D, chunk=chunk)
        return y[:, :s], f

    before = sops.ssd_scan.launches
    y, got = grads(lambda *a: sops.ssd_scan(*a, chunk=chunk))
    assert sops.ssd_scan.launches == before + 1      # none in the backward
    yr, ref = grads(plain)
    torch.cuda.synchronize()
    assert float((y.float() - yr.float()).abs().max()) < 5e-2
    for a, r in zip(got, ref):
        top = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= 1e-5 * top


def test_serving_flash_call_is_unchanged_without_grad(cuda_device):
    """Under inference_mode (the serving path) the wrapper launches the
    kernel once with lse null, no autograd node, the output bit-equal to
    the training forward's."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(5)
    q, k, v = (torch.randn((4, 512, 32, 80), generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    before = fops.flash_attention.launches
    with torch.inference_mode():
        out = fops.flash_attention(q, k, v)
    assert fops.flash_attention.launches == before + 1
    assert out.grad_fn is None
    train_out, lse = fops.flash_forward(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, train_out) and torch.isfinite(lse).all()


# ---------------------------------------------- the mesh layer on the card
_MESH_AXES = ("data", "model")


def _small_mesh_state() -> dict:
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.arange(32, dtype=torch.float32).reshape(4, 8)
                      .to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}


def _rank_save_sharded_on_cpu(directory):
    """A rank of a 4-rank gloo job on the CPU: the small state sharded on a
    (2, 2) mesh, saved collectively."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.ckpt.checkpoint import save_checkpoint
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.sharding import P, to_placements
    mesh = tmesh.make_mesh((2, 2), _MESH_AXES, device_type="cpu")
    specs = {"w": P("data", "model"), "b": P(None, "model"), "step": P()}
    state = {k: distribute_tensor(v, mesh, to_placements(specs[k], mesh))
             for k, v in _small_mesh_state().items()}
    return str(save_checkpoint(directory, state, 3, n_io_ranks=4))


@pytest.fixture()
def card_mesh(cuda_device):
    """A (1, 1) mesh on the card: a one-rank nccl group that `make_mesh`
    brings up itself, torn down after the test."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    assert not dist.is_initialized()
    mesh = tmesh.make_mesh((1, 1), _MESH_AXES)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_make_mesh_on_the_card(card_mesh):
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    assert card_mesh.device_type == "cuda"
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert tmesh.mesh_summary(card_mesh) == {
        "axis_names": ["data", "model"], "shape": [1, 1], "n_devices": 1}


def test_restore_sharded_onto_the_card_from_a_cpu_sharded_checkpoint(
        card_mesh, tmp_path):
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt.checkpoint import restore_sharded
    from repro_torch.launch.distributed import RankPool
    from repro_torch.launch.sharding import NamedSharding, P
    with RankPool(4, tmp_path / "store", timeout=180) as pool:
        pool.run(_rank_save_sharded_on_cpu, str(tmp_path / "ckpt"))
    full = _small_mesh_state()
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in full.items()}
    specs = {"w": P("model", "data"), "b": P(None, "data"), "step": P()}
    out, step = restore_sharded(tmp_path / "ckpt", like,
                                {k: NamedSharding(card_mesh, s)
                                 for k, s in specs.items()})
    assert step == 3
    for k, v in full.items():
        assert isinstance(out[k], DTensor)
        loc = out[k].to_local()
        assert loc.is_cuda and loc.dtype == v.dtype
        assert torch.equal(loc.cpu(), v), k


def _dtensor_state(state, mesh):
    """`state` as DTensors on a one-device mesh, sharing its storage."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.optim.tree import tree_map
    return tree_map(lambda t: DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False), state)


def test_dtensor_state_device_compressed_save_makes_the_plain_files(
        card_mesh, tmp_path):
    from repro_torch.ckpt.checkpoint import checkpoint_path, save_checkpoint
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.core.bp_engine import EngineConfig
    from repro_torch.train.state import init_train_state
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    plain = init_train_state(cfg, 0)
    engine = EngineConfig(codec="blosc")
    launches = []
    for sub, state in (("plain", plain),
                       ("dtensor", _dtensor_state(plain, card_mesh))):
        before = bops.shuffle_blocks.launches
        save_checkpoint(tmp_path / sub, state, 1, engine_config=engine,
                        device_compress=True)
        launches.append(bops.shuffle_blocks.launches - before)
    assert launches[0] == launches[1] > 0
    p, d = (checkpoint_path(tmp_path / s, 1) for s in ("plain", "dtensor"))
    names = sorted(x.name for x in p.iterdir())
    for name in names:
        if name.startswith("data.") or name == "md.0":
            assert (p / name).read_bytes() == (d / name).read_bytes(), name


def test_train_step_on_a_dtensor_state_equals_the_plain_state(card_mesh):
    import os
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import SyntheticTokens, to_device
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    batch = to_device(SyntheticTokens(cfg.padded_vocab, 64, 4, seed=0)
                      .batch_at(0), "cuda")
    fn = make_train_step(cfg, AdamWConfig(warmup_steps=1), q_chunk=64,
                         kv_chunk=64)
    plain = init_train_state(cfg, 0)
    dstate = _dtensor_state(init_train_state(cfg, 0), card_mesh)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        before = fops.flash_attention.launches
        _, m_plain = fn(plain, batch)
        _, m_d = fn(dstate, batch)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    # remat: a forward and a recompute launch a layer, in each step
    assert fops.flash_attention.launches - before == 2 * 2 * cfg.n_layers
    assert float(m_plain["loss"]) == float(m_d["loss"])
    for a, b in zip(tree_leaves(plain), tree_leaves(dstate)):
        assert torch.equal(a, b.to_local())
    assert int(dstate["step"].to_local()) == 1


# ------------------------------------- the kernels under local_map (PR 19)
def _replicated_on(mesh, *ts):
    from torch.distributed.tensor import DTensor, Replicate
    return [DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False) for t in ts]


def test_flash_and_ssd_through_local_map_equal_the_direct_calls(card_mesh):
    """On a (1, 1) cuda mesh the kernels run on the DTensors' local
    tensors: flash with its lse and the SSD scan, bit for bit the direct
    calls, one launch each."""
    from repro_torch import meshctx
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g, device="cuda")
               .bfloat16() for _ in range(3))
    want = fops.flash_forward(q, k, v, causal=True)
    spec = (meshctx.BATCH, None, "model", None)
    before = fops.flash_attention.launches
    got = meshctx.local_map(
        lambda a, b, c: fops.flash_forward(a, b, c, causal=True),
        tuple(_replicated_on(card_mesh, q, k, v)), (spec,) * 3,
        (spec, (meshctx.BATCH, "model", None)),
        ((2, 128, 4, 64), (2, 4, 128)))
    assert fops.flash_attention.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.to_local(), b)
    b_, s, h, p, n = 2, 256, 4, 64, 64
    x = torch.randn(b_, s, h, p, generator=g, device="cuda").bfloat16()
    dt = torch.rand(b_, s, h, generator=g, device="cuda") * 0.1
    A = -torch.linspace(1.0, 4.0, h, device="cuda")
    B, C = (torch.randn(b_, s, n, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    D = torch.ones(h, device="cuda")
    want = sops.ssd_scan(x, dt, A, B, C, D, chunk=64)
    hs = (meshctx.BATCH, None, "model", None)
    before = sops.ssd_scan.launches
    got = meshctx.local_map(
        lambda *a: sops.ssd_scan(*a, chunk=64),
        tuple(_replicated_on(card_mesh, x, dt, A, B, C, D)),
        (hs, (meshctx.BATCH, None, "model"), ("model",),
         (meshctx.BATCH, None, None), (meshctx.BATCH, None, None),
         ("model",)),
        (hs, (meshctx.BATCH, "model", None, None)),
        ((b_, s, h, p), (b_, h, p, n)))
    assert sops.ssd_scan.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.to_local(), b)


def test_kernel_wrappers_refuse_a_dtensor(card_mesh):
    (q,) = _replicated_on(card_mesh, torch.zeros(
        1, 64, 2, 64, dtype=torch.bfloat16, device="cuda"))
    before = (fops.flash_attention.launches, sops.ssd_scan.launches,
              bops.shuffle_blocks.launches)
    with pytest.raises(TypeError, match="DTensor"):
        fops.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="DTensor"):
        fops.flash_forward(q, q, q)
    x, dt, A, B = _replicated_on(
        card_mesh, torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16,
                               device="cuda"),
        torch.zeros(1, 64, 2, device="cuda"), torch.ones(2, device="cuda"),
        torch.zeros(1, 64, 16, dtype=torch.bfloat16, device="cuda"))
    with pytest.raises(TypeError, match="DTensor"):
        sops.ssd_scan(x, dt, A, B, B, A)
    (raw,) = _replicated_on(card_mesh, torch.zeros(4096, dtype=torch.uint8,
                                                   device="cuda"))
    for fn, kw in ((bops.shuffle_blocks, {"block": 1024, "itemsize": 4}),
                   (bops.shuffle_block, {"itemsize": 4}),
                   (bops.shuffle, {"itemsize": 4})):
        with pytest.raises(TypeError, match="DTensor"):
            fn(raw, **kw)
    assert (fops.flash_attention.launches, sops.ssd_scan.launches,
            bops.shuffle_blocks.launches) == before


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "deepseek-moe-16b"])
def test_train_step_on_train_state_shardings_equals_the_plain_step(
        card_mesh, arch):
    """A smoke state laid out by `train_state_shardings` on the (1, 1)
    cuda mesh steps through DTensor ops and the kernels under local_map:
    loss and every leaf bit-equal to the plain step, the kernels' launches
    those of the plain step."""
    import os
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import SyntheticTokens, to_device
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.train.state import (init_train_state,
                                         train_state_shardings)
    from repro_torch.train.step import make_train_step
    cfg = reduce_for_smoke(get_config(arch))
    batch = to_device(SyntheticTokens(cfg.padded_vocab, 128, 4, seed=0)
                      .batch_at(0), "cuda")
    fn = make_train_step(cfg, AdamWConfig(warmup_steps=1), ssd_chunk=64)
    plain = init_train_state(cfg, 0)
    dstate = tree_map(lambda t, s: distribute_tensor(t.clone(), s.mesh,
                                                     s.placements),
                      init_train_state(cfg, 0),
                      train_state_shardings(cfg, card_mesh))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    launches = []
    try:
        for state in (plain, dstate):
            before = (fops.flash_attention.launches, sops.ssd_scan.launches)
            _, m = fn(state, batch)
            torch.cuda.synchronize()
            launches.append((fops.flash_attention.launches - before[0],
                             sops.ssd_scan.launches - before[1],
                             float(m["loss"])))
    finally:
        torch.use_deterministic_algorithms(prev)
    assert launches[0] == launches[1] and launches[0][0] > 0
    for a, b in zip(tree_leaves(plain), tree_leaves(dstate)):
        assert torch.equal(a, b.to_local())


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "smollm-360m",
                                  "deepseek-moe-16b"])
def test_decode_on_a_dtensor_cache_equals_the_plain_decode(card_mesh, arch):
    """The smoke config's prefill and 4 greedy decode steps on the (1, 1)
    cuda mesh, DTensor params and a cache laid out by
    `cache_sharding_tree`, against the plain decode: every step's logits
    and tokens bit-equal, every cache leaf laid out as
    `cache_sharding_tree` says, the kernels launched by the prefill
    alike."""
    import dataclasses
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.launch import sharding as S
    from repro_torch.meshctx import is_dtensor
    from repro_torch.models import model as M
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.serve.steps import grow_cache
    cfg = reduce_for_smoke(get_config(arch))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    plain = M.init_params(cfg, 0)
    dparams = tree_map(lambda t, s: distribute_tensor(t.clone(), s.mesh,
                                                      s.placements),
                       plain, S.param_sharding_tree(cfg, card_mesh,
                                                    M.param_shapes(cfg)))
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 96), generator=gen,
                           device="cuda")
    runs = []
    for params in (plain, dparams):
        before = (fops.flash_attention.launches, sops.ssd_scan.launches)
        with torch.inference_mode():
            logits, cache = M.prefill(params, cfg, {"tokens": prompt})
            launched = (fops.flash_attention.launches - before[0],
                        sops.ssd_scan.launches - before[1])
            cache = grow_cache(cache, 128)
            out = [logits[:, -1:]]
            for i in range(4):
                tok = torch.argmax(out[-1][:, -1], dim=-1)[:, None]
                if is_dtensor(tok):
                    tok = tok.full_tensor()
                logits, cache = M.decode_step(params, cfg, tok, cache,
                                              96 + i)
                out.append(logits)
        runs.append(([o.full_tensor() if is_dtensor(o) else o
                      for o in out], cache, launched))
    (p_out, _, p_l), (d_out, d_cache, d_l) = runs
    assert p_l == d_l and sum(p_l) > 0
    for a, b in zip(p_out, d_out):
        assert torch.equal(a, b)
    want = S.cache_sharding_tree(cfg, card_mesh, d_cache)
    for t, w in zip(tree_leaves(d_cache), tree_leaves(want)):
        assert tuple(t.placements) == tuple(w.placements)


def test_custom_ops_fake_outputs_match_a_real_launch(cuda_device):
    """The fake implementations of `repro_torch::flash_fwd` and
    `repro_torch::ssd_scan` (the dry-run's route for a fake tensor) give
    the shapes and dtypes a real launch of each kernel gives, and the ops
    on real CUDA tensors equal the wrappers' kernel calls."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 200, 4, 80, generator=g, device="cuda")
               .bfloat16() for _ in range(3))
    real = fops.flash_forward(q, k, v, causal=True)
    op = torch.ops.repro_torch.flash_fwd(q, k, v, True)
    for a, b in zip(real, op):
        assert torch.equal(a, b)
    b_, s, h, p, n = 2, 256, 4, 64, 16
    x = torch.randn(b_, s, h, p, generator=g, device="cuda").bfloat16()
    dt = torch.rand(b_, s, h, generator=g, device="cuda") * 0.1
    A = -torch.linspace(1.0, 2.0, h, device="cuda")
    B = torch.randn(b_, s, n, generator=g, device="cuda").bfloat16()
    D = torch.ones(h, device="cuda")
    real_ssd = sops.ssd_scan(x, dt, A, B, B, D, chunk=128)
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fake = fops.flash_forward(fq, fk, fv, causal=True)
        fargs = [mode.from_tensor(t) for t in (x, dt, A, B, B, D)]
        fake_ssd = sops.ssd_scan(*fargs, chunk=128)
    for got, want in zip((*fake, *fake_ssd), (*real, *real_ssd)):
        assert (got.shape, got.dtype, got.device) == (want.shape, want.dtype,
                                                      want.device)


def _rank_gloo_on_the_card():
    """A rank of 4 gloo ranks that share cuda:0: `make_mesh` on "cuda"
    installs the repaired functional all-gather, whose gather of a CUDA
    tensor must equal the c10d gather; then a forward of the smoke
    smollm-360m config on the (2, 2) mesh, params laid out by
    `param_sharding_tree` on the card, with this rank's flash launches."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as S
    from repro_torch.models import model as M
    from repro_torch.optim.tree import tree_map
    from repro_torch.train.state import shard_batch
    torch.cuda.set_device(0)
    mesh = tmesh.make_mesh((2, 2), _MESH_AXES, device_type="cuda")
    x = (torch.arange(12, dtype=torch.float32).reshape(4, 3)
         + 100 * dist.get_rank()).cuda().to(torch.bfloat16)
    got = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, dist.group.WORLD))
    want = torch.empty_like(got)
    dist.all_gather_into_tensor(want, x)
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    sh = S.param_sharding_tree(cfg, mesh, M.param_shapes(cfg))
    params = tree_map(lambda t, s: distribute_tensor(t, mesh, s.placements),
                      M.init_params(cfg, 0, device="cpu"), sh)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64),
                           generator=torch.Generator().manual_seed(0))
    fops.flash_attention.launches = 0
    with torch.no_grad():
        logits, _ = M.forward(params, cfg,
                              shard_batch({"tokens": tokens.cuda()}, mesh),
                              q_chunk=64, kv_chunk=64)
    torch.cuda.synchronize()
    whole = logits.full_tensor()
    return {"gather_equal": got.is_cuda and torch.equal(got, want),
            "device": str(logits.to_local().device),
            "flash": fops.flash_attention.launches,
            "shape": list(whole.shape),
            "finite": bool(torch.isfinite(whole).all())}


def test_four_gloo_ranks_gather_and_run_flash_on_the_card(cuda_device,
                                                         tmp_path):
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.launch.distributed import RankPool
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    with RankPool(4, tmp_path / "store", timeout=300) as pool:
        res = pool.run(_rank_gloo_on_the_card)
    for r in res:
        assert r["gather_equal"] and r["finite"], r
        assert r["device"] == "cuda:0"
        assert r["flash"] == cfg.n_layers
        assert r["shape"] == [4, 64, cfg.padded_vocab]
