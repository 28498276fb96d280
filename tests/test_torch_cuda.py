"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; each test skips where no CUDA device is visible.
Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.compression import byte_shuffle
from repro_torch.kernels.bitshuffle import ops as bops
from repro_torch.kernels.deposit import ops as dops
from repro_torch.kernels.deposit.ref import deposit_ref

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
