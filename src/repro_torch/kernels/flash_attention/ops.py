"""Public wrapper of the flash attention forward: a CUDA tensor goes to the
kernel (`csrc/flash_attention.cu`), a CPU tensor to the plain version
(`ref.py`). Layout [B,S,H,D] in and out, as the model keeps it: the kernel
reads q/k/v in place through their strides, so there is no transpose and
no padding of S (ragged S is masked inside the kernel).

With grad enabled and an input that requires it, the call goes through
`FlashAttention`, a `torch.autograd.Function`: its forward is the same
kernel (or plain version), which also writes the row log-sum-exp, and its
backward is `ref.flash_attention_bwd_plain`, the plain mirror of the JAX
package's `_flash_bwd_impl` (jnp there, not a Pallas kernel)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_plain, flash_fwd_plain)

HEAD_DIMS = (32, 64, 80, 96, 128)
_SIGNATURES = {"jbp_flash_attention_fwd": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, *(ctypes.c_longlong,) * 9,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p)}


def _check_operand(name, t, dev):
    if not t.is_cuda or t.device != dev:
        raise ValueError("flash_attention: q, k and v must be on one CUDA "
                         "device")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16, got "
                        f"{t.dtype}")
    if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} needs a unit stride on D, "
                         f"other strides a multiple of 8 elements and a "
                         f"16-byte aligned start (16-byte row loads)")


def flash_attention(q, k, v, *, causal: bool = True, qc: int = 512,
                    kc: int = 512) -> torch.Tensor:
    """q: [B,Sq,H,D], k/v: [B,Skv,H,D] (H(q) == H(kv); GQA callers expand
    first) -> [B,Sq,H,D] in q's dtype. `qc`/`kc` are the plain version's
    chunks (and the backward's); the kernel tiles by 64. Differentiable
    when grad is enabled (`FlashAttention`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, qc, kc)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, q_chunk=qc,
                                     kv_chunk=kc)
    return _kernel(q, k, v, causal)[0]


def flash_forward(q, k, v, *, causal: bool = True, qc: int = 512,
                  kc: int = 512):
    """(out [B,Sq,H,D], lse [B,H,Sq] fp32): the kernel with its `lse`
    output on a CUDA tensor, the plain version on a CPU one."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal=causal, q_chunk=qc,
                               kv_chunk=kc)
    return _kernel(q, k, v, causal, with_lse=True)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the JAX package's custom VJP: the forward
    saves q, k, v, out and the row log-sum-exp; the backward recomputes
    the probabilities tile by tile (`flash_attention_bwd_plain`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, qc, kc):
        out, lse = flash_forward(q, k, v, causal=causal, qc=qc, kc=kc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, qc, kc)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, qc, kc = ctx.args
        dq, dk, dv = flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal=causal, q_chunk=qc, kv_chunk=kc)
        return dq, dk, dv, None, None, None


def _kernel(q, k, v, causal: bool, with_lse: bool = False):
    """One launch of the CUDA kernel: (out, lse or None)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if Skv == 0:
        raise ValueError("flash_attention: empty key sequence")
    lib = _build.load("flash_attention", _SIGNATURES)
    with _build.on_device(q):
        rc = lib.jbp_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            B, H, Sq, Skv, D, int(causal), 1.0 / (D ** 0.5),
            _build.stream_of(q))
    _build.check(rc, "jbp_flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
