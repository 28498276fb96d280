"""Public wrapper of the Mamba2 SSD scan: layout [b,s,h,p] as in
`models/ssm.py`; s is padded with zeros to whole chunks, then a CUDA tensor
goes to the kernel (`csrc/ssd_scan.cu`), a CPU tensor to the plain version
(`ref.py`).

Zero padding is exact for the final state: a padded step has dt = 0, so it
neither decays nor updates the state. So unlike `ssd_chunked`, this wrapper
takes any s (a prompt of 520 tokens runs as 5 chunks of 128).

With grad enabled and an input that requires it, the padded call goes
through `SsdScan`, a `torch.autograd.Function` whose forward is the same
kernel (or plain version) and whose backward recomputes the plain
`ssd_chunked` on the same padded inputs and differentiates it: the JAX
package differentiates `ssd_chunked` by autodiff (`models/ssm.py`)."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import COMPUTE_DTYPE, ssd_chunked

DEFAULT_CHUNK = 128
MAX_CHUNK = 128
#: state widths the kernel is built for, and the slice of p a block takes
KERNEL_N = (16, 32, 64, 128)
P_SLICE = 32
_SIGNATURES = {"jbp_ssd_scan": (
    *(ctypes.c_void_p,) * 10, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it where its start is not 16-byte aligned (the
    kernel reads x, B and C by 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel(x, dt, A, B, C, D, chunk, initial_state):
    """Two launches: `ssd_cb_kernel` (C.B^T once per batch and chunk, into
    an fp32 scratch) and `ssd_chunk_scan_kernel`; one call of the
    wrapper."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if chunk > MAX_CHUNK or n not in KERNEL_N or p % P_SLICE:
        raise ValueError(f"ssd_scan kernel: chunk {chunk} (<= {MAX_CHUNK}), "
                         f"n {n} (one of {KERNEL_N}), p {p} (a multiple of "
                         f"{P_SLICE})")
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
    x, B, C = _aligned(x), _aligned(B), _aligned(C)
    y = torch.empty((b, s, h, p), dtype=COMPUTE_DTYPE, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty((b, s // chunk, MAX_CHUNK, MAX_CHUNK),
                          dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_scan", _SIGNATURES)
    with _build.on_device(x):
        rc = lib.jbp_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), init, scratch.data_ptr(),
            y.data_ptr(), final.data_ptr(), b, s, h, p, n, chunk,
            _build.stream_of(x))
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
    args = (x, dt, A, B, C, D, initial_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        y, final = SsdScan.apply(chunk, *args)
    else:
        y, final = _forward(chunk, *args)
    return (y[:, :s] if pad else y), final


ssd_scan.launches = 0


def _forward(chunk, x, dt, A, B, C, D, initial_state):
    """The kernel on a CUDA tensor, the plain version on a CPU one, on
    inputs already padded to whole chunks."""
    if x.is_cuda:
        return _kernel(x, dt, A, B, C, D, chunk, initial_state)
    return ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                       initial_state=initial_state)


class SsdScan(torch.autograd.Function):
    """The scan of padded inputs with a gradient: the forward is
    `_forward`; the backward runs `ssd_chunked` again on the saved inputs
    under autograd and returns its gradients."""

    @staticmethod
    def forward(ctx, chunk, x, dt, A, B, C, D, initial_state):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)     # an unused final state: None
        ctx.save_for_backward(x, dt, A, B, C, D, initial_state)
        return _forward(chunk, x, dt, A, B, C, D, initial_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(saved, ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            y, final = ssd_chunked(*inputs[:6], chunk=ctx.chunk,
                                   initial_state=inputs[6])
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        pairs = [(o, g) for o, g in ((y, dy), (final, dfinal))
                 if g is not None]
        if not pairs:
            return (None,) * 8
        outs, grads = zip(*pairs)
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, *(next(got) if t is not None and t.requires_grad
                        else None for t in inputs))
