"""Public wrapper of the Mamba2 SSD scan: layout [b,s,h,p] as in
`models/ssm.py`; s is padded with zeros to whole chunks, then a CUDA tensor
goes to the kernel (`csrc/ssd_scan.cu`), a CPU tensor to the plain version
(`ref.py`).

Zero padding is exact for the final state: a padded step has dt = 0, so it
neither decays nor updates the state. So unlike `ssd_chunked`, this wrapper
takes any s (a prompt of 520 tokens runs as 5 chunks of 128)."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import COMPUTE_DTYPE, ssd_chunked

DEFAULT_CHUNK = 128
MAX_CHUNK = 128
#: shared memory a block may use on Hopper (227 KB)
MAX_SMEM = 232_448
_SIGNATURES = {"jbp_ssd_scan": (
    *(ctypes.c_void_p,) * 9, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)}


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block: state [n,p], x*dt [q,p] and the
    decay-masked scores [q,q+1] in fp32, three [q] fp32 vectors, and B and
    C as bf16 rows of n+2."""
    return (4 * (n * p + chunk * p + chunk * (chunk + 1) + 3 * chunk)
            + 2 * 2 * chunk * (n + 2))


def _kernel(x, dt, A, B, C, D, chunk, initial_state):
    b, s, h, p = x.shape
    n = B.shape[-1]
    if chunk > MAX_CHUNK or n % 2 or smem_bytes(chunk, p, n) > MAX_SMEM:
        raise ValueError(f"ssd_scan kernel: chunk {chunk} (<= {MAX_CHUNK}), "
                         f"p {p}, n {n} (even) need "
                         f"{smem_bytes(chunk, p, n)} B of shared memory "
                         f"(<= {MAX_SMEM})")
    _build.require_cuda("ssd_scan", x, B, C, dtype=torch.bfloat16)
    _build.require_cuda("ssd_scan", dt, A, D, dtype=torch.float32)
    if any(t.device != x.device for t in (dt, A, D)):
        raise ValueError("ssd_scan: all inputs must be on one CUDA device")
    if (dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,)
            or B.shape != (b, s, n) or C.shape != (b, s, n)):
        raise ValueError("ssd_scan: shapes do not match x [b,s,h,p]")
    init = 0
    if initial_state is not None:
        _build.require_cuda("ssd_scan", initial_state, dtype=torch.float32)
        if initial_state.shape != (b, h, p, n):
            raise ValueError("ssd_scan: initial_state must be [b,h,p,n]")
        init = initial_state.data_ptr()
    y = torch.empty((b, s, h, p), dtype=COMPUTE_DTYPE, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_scan", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.jbp_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), init, y.data_ptr(), final.data_ptr(),
            b, s, h, p, n, chunk, smem_bytes(chunk, p, n), _build.stream_of(x))
    _build.check(rc, "jbp_ssd_scan")
    ssd_scan.launches += 1
    return y, final


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = DEFAULT_CHUNK,
             initial_state=None):
    """Same contract as `ref.ssd_chunked`: x:[b,s,h,p], dt:[b,s,h],
    A/D:[h], B/C:[b,s,n] -> (y [b,s,h,p] bf16, final state [b,h,p,n]
    fp32). On the card x, B and C are bf16 and dt, A, D fp32."""
    s = x.shape[1]
    if s == 0:
        raise ValueError("ssd_scan: empty sequence")
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    if x.is_cuda:
        y, final = _kernel(x, dt, A, B, C, D, chunk, initial_state)
    else:
        y, final = ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                               initial_state=initial_state)
    return (y[:, :s] if pad else y), final


ssd_scan.launches = 0
