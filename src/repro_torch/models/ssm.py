"""Mamba2 (SSD, state-space duality) block, the port of the JAX package's
`models/ssm.py`.

The full-sequence pass (`mamba2_seq`, training and prefill) runs the chunked scan through
`kernels/ssd_scan/ops.py`: the hand-written CUDA kernel on the card, on the
CPU the plain `ssd_chunked` (the JAX package's oracle, re-exported here
with `ssd_recurrent_reference`); with grad enabled the wrapper's autograd
Function differentiates `ssd_chunked`, as the JAX package does. Decode (`mamba2_step`) is one recurrent
step in plain PyTorch, as in the JAX package. Projections and convs are
stored split (z / x / B / C / dt), as there.

On DTensors the chunked core runs under `local_map`, on each rank's batch
and SSM heads: x and dt laid out as the reference's hints on its chunked
`xc` and `dtc` (batch on the batch axes, heads on `_ssm_head_axis`), the
initial and final state as its `h0` and carried state, B and C (group
shared) whole over `model`. The kernel, or on the CPU the plain scan with
its decays, cumsums and segment sums, so sees local tensors only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (  # noqa: F401
    ssd_chunked, ssd_recurrent_reference)
from repro_torch.meshctx import BATCH, axis_size, local_map
from repro_torch.models.layers import (COMPUTE_DTYPE, init_linear,
                                       init_rmsnorm, linear, normal, rms_norm)


def _ssm_head_axis(n_heads: int):
    tp = axis_size("model")
    return "model" if (tp > 1 and n_heads % tp == 0) else None


# ----------------------------------------------------------------- init
def init_mamba2(gen, cfg, *, device, dtype=torch.float32):
    d_in = cfg.d_inner
    H = cfg.n_ssm_heads
    N = cfg.ssm_state
    K = cfg.ssm_conv
    kw = dict(device=device, dtype=dtype)

    def conv(c):
        return {"w": (normal(gen, (K, c), device=device) / K).to(dtype),
                "b": torch.zeros((c,), **kw)}

    def const(a):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dtype)

    return {
        "wz": init_linear(gen, cfg.d_model, d_in, **kw),
        "wx": init_linear(gen, cfg.d_model, d_in, **kw),
        "wB": init_linear(gen, cfg.d_model, N, **kw),
        "wC": init_linear(gen, cfg.d_model, N, **kw),
        "wdt": init_linear(gen, cfg.d_model, H, **kw),
        "conv_x": conv(d_in),
        "conv_B": conv(N),
        "conv_C": conv(N),
        "A_log": const(np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))),
        "D": torch.ones((H,), **kw),
        "dt_bias": const(np.log(np.expm1(
            np.geomspace(1e-3, 1e-1, H, dtype=np.float32)))),
        "norm": init_rmsnorm(d_in, **kw),
        "out_proj": init_linear(gen, d_in, cfg.d_model, **kw),
    }


# ----------------------------------------------------------- full block
def _causal_conv(x, conv, *, tail=None):
    """Depthwise causal conv + silu. x:[b,s,c]; conv.w:[k,c]. tail:[b,k-1,c].
    The taps add in bf16, one after the other, as in the JAX package."""
    w = conv["w"].to(COMPUTE_DTYPE)
    bvec = conv["b"].to(COMPUTE_DTYPE)
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    padded = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    out = sum(padded[:, i:i + S] * w[i] for i in range(k))
    new_tail = padded[:, padded.shape[1] - (k - 1):] if k > 1 else tail
    out = F.silu((out + bvec).float())
    return out.to(COMPUTE_DTYPE), new_tail


def _project(p, u):
    return (linear(p["wz"], u), linear(p["wx"], u), linear(p["wB"], u),
            linear(p["wC"], u), linear(p["wdt"], u))


def _gate_norm_out(p, y, z, cfg):
    y = rms_norm(p["norm"], y * F.silu(z.float()).to(COMPUTE_DTYPE),
                 cfg.norm_eps)
    return linear(p["out_proj"], y)


def _scan(x, dt, A, B, C, D, chunk, initial_state):
    """The chunked SSD scan, under `local_map` on DTensors."""
    b, s, H, P = x.shape
    h = _ssm_head_axis(H)
    state = (BATCH, h, None, None)
    specs = ((BATCH, None, h, None), (BATCH, None, h), (h,),
             (BATCH, None, None), (BATCH, None, None), (h,),
             None if initial_state is None else state)
    return local_map(
        lambda x_, dt_, A_, B_, C_, D_, h0: ssd_ops.ssd_scan(
            x_, dt_, A_, B_, C_, D_, chunk=chunk, initial_state=h0),
        (x, dt, A, B, C, D, initial_state), specs,
        ((BATCH, None, h, None), state),
        ((b, s, H, P), (b, H, P, B.shape[-1])), site="ssm.scan")


def mamba2_seq(p, u, *, cfg, initial_state=None, conv_tails=None, chunk=128):
    """Full-sequence Mamba2 block. u:[b,s,d_model] ->
    (y, (ssm_state bf16, (tail_x, tail_B, tail_C)))."""
    b, s, _ = u.shape
    H, P = cfg.n_ssm_heads, cfg.ssm_headdim
    z, x, B, C, dt_raw = _project(p, u)
    tx, tB, tC = conv_tails if conv_tails is not None else (None, None, None)
    x, tx = _causal_conv(x, p["conv_x"], tail=tx)
    B, tB = _causal_conv(B, p["conv_B"], tail=tB)
    C, tC = _causal_conv(C, p["conv_C"], tail=tC)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, final = _scan(x.reshape(b, s, H, P), dt, A, B, C, p["D"].float(),
                     chunk, initial_state)
    y = _gate_norm_out(p, y.reshape(b, s, cfg.d_inner), z, cfg)
    return y, (final.to(COMPUTE_DTYPE), (tx, tB, tC))


def _step_core(x, B, C, dt_raw, tx, tB, tC, wx, bx, wB, bB, wC, bC,
               dt_bias, A_log, D, ssm_state):
    """The recurrence of one decode token after the projections: the
    causal convs (weights w*, biases b*) against their tails, one SSD step
    from `ssm_state` [b,H,P,N] (H the heads of `dt_raw`, the rank's own on
    a mesh). -> (y [b,1,H*P] bf16, new state bf16, new tails)."""
    b, H = x.shape[0], dt_raw.shape[-1]
    P = x.shape[-1] // H
    x, tx = _causal_conv(x, {"w": wx, "b": bx}, tail=tx)
    B, tB = _causal_conv(B, {"w": wB, "b": bB}, tail=tB)
    C, tC = _causal_conv(C, {"w": wC, "b": bC}, tail=tC)
    x = x[:, 0].reshape(b, H, P).float()
    B = B[:, 0].float()
    C = C[:, 0].float()
    dt = F.softplus(dt_raw[:, 0].float() + dt_bias.float())
    A = -torch.exp(A_log.float())
    decay = torch.exp(dt * A)                                   # [b,H]
    upd = torch.einsum("bhp,bn->bhpn", x * dt[..., None], B)
    new_state = ssm_state.float() * decay[..., None, None] + upd
    y = (torch.einsum("bhpn,bn->bhp", new_state, C)
         + D.float()[None, :, None] * x)
    return (y.reshape(b, 1, H * P).to(COMPUTE_DTYPE),
            new_state.to(COMPUTE_DTYPE), tx, tB, tC)


def mamba2_step(p, u, ssm_state, conv_tails, *, cfg):
    """One-token decode. u:[b,1,d_model] -> (y, (state bf16, tails)).

    The recurrence runs under `local_map`: on DTensors, on each rank's batch
    rows (over `data`, as the cache lies) and SSM heads (over `model`
    where they divide: d_inner's channels, the state's heads, the x
    conv's tail and weights); the einsums over the state width N are
    local."""
    b = u.shape[0]
    H, P, N = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    z, x, B, C, dt_raw = _project(p, u)
    args = (x, B, C, dt_raw, *conv_tails,
            *(p[c][k] for c in ("conv_x", "conv_B", "conv_C")
              for k in ("w", "b")),
            p["dt_bias"], p["A_log"], p["D"], ssm_state)
    h = _ssm_head_axis(H)
    row, ch = ("data", None, None), ("data", None, h)
    state = ("data", h, None, None)
    d_in, K = cfg.d_inner, cfg.ssm_conv
    y, st, tx, tB, tC = local_map(
        _step_core, args,
        (ch, row, row, ch, ch, row, row,
         (None, h), (h,), (None, None), (None,), (None, None), (None,),
         (h,), (h,), (h,), state),
        (ch, state, ch, row, row),
        ((b, 1, d_in), (b, H, P, N), (b, K - 1, d_in), (b, K - 1, N),
         (b, K - 1, N)), site="ssm.step")
    return _gate_norm_out(p, y, z, cfg), (st, (tx, tB, tC))
