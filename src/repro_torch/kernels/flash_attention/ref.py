"""Plain PyTorch flash attention: the JAX package's chunked online-softmax
oracle (`models/attention.py::_flash_fwd_impl` with `_fit_chunk`), its
memory-efficient backward (`_flash_bwd_impl`), both rewritten, and the
O(S^2) reference.

The plain version rounds the probabilities to v's dtype before the PV
product and returns q's dtype, as the TPU kernel does
(`kernels/flash_attention/kernel.py:57,65`). On the model's bf16 inputs
that is exactly the jnp oracle, which rounds to bf16 at those two points;
on fp32 inputs it stays fp32 like the TPU kernel, where the jnp oracle
would still round to bf16.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def fit_chunk(S: int, c: int) -> int:
    """Largest divisor of S that is <= c (handles Skv like 1600)."""
    c = min(c, S)
    while S % c:
        c -= 1
    return c


def _causal_bias(qi, ki, q_chunk, kv_chunk, device):
    qp = qi * q_chunk + torch.arange(q_chunk, device=device)
    kp = ki * kv_chunk + torch.arange(kv_chunk, device=device)
    return torch.where(kp[None, :] <= qp[:, None], 0.0, NEG_INF)   # [qc,kc]


def flash_attention_plain(q, k, v, *, causal=True, q_chunk=1024,
                          kv_chunk=1024):
    """q/k/v: [B,S,H,D] with H(q) == H(kv) -> out [B,Sq,H,D] in q's dtype.
    fp32 m/l/acc; scores and PV are fp32 products of the input values."""
    return flash_fwd_plain(q, k, v, causal=causal, q_chunk=q_chunk,
                           kv_chunk=kv_chunk)[0]


def _check_grouping(q, k):
    if k.shape[2] != q.shape[2]:
        raise ValueError(
            f"flash core is ungrouped; expand KV heads first "
            f"(q {tuple(q.shape)} has {q.shape[2]} heads, kv "
            f"{tuple(k.shape)} has {k.shape[2]})")


def flash_fwd_plain(q, k, v, *, causal=True, q_chunk=1024, kv_chunk=1024):
    """`flash_attention_plain` and the row log-sum-exp of the scaled
    scores, lse = m + log(max(l, 1e-30)) fp32 [B,H,Sq] (natural units, as
    `_flash_fwd_impl` returns it)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    _check_grouping(q, k)
    qc = fit_chunk(Sq, q_chunk)
    kc = fit_chunk(Skv, kv_chunk)
    scale = 1.0 / (D ** 0.5)
    qf, kf = q.float(), k.float()
    outs, lses = [], []
    for qi in range(Sq // qc):
        qb = qf[:, qi * qc:(qi + 1) * qc]                          # [B,qc,H,D]
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, D), dtype=torch.float32, device=q.device)
        for ki in range(Skv // kc):
            kb = kf[:, ki * kc:(ki + 1) * kc]
            vb = v[:, ki * kc:(ki + 1) * kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            if causal:
                s = s + _causal_bias(qi, ki, qc, kc, q.device)[None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vb.float())
            m = m_new
        out = (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
        outs.append(out.transpose(1, 2))                           # [B,qc,H,D]
        lses.append(m + torch.log(torch.clamp_min(l, 1e-30)))      # [B,H,qc]
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal=True,
                              q_chunk=1024, kv_chunk=1024):
    """The JAX package's `_flash_bwd_impl`: recomputes p = exp(s - lse)
    tile by tile (never the O(S^2) probabilities at once). Products are
    fp32 products of the inputs' values (bf16 on the model's path); p and
    ds round to bf16 at the reference's two points. Returns (dq, dk, dv)
    in q's, k's and v's dtypes."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    _check_grouping(q, k)
    qc = fit_chunk(Sq, q_chunk)
    kc = fit_chunk(Skv, kv_chunk)
    scale = 1.0 / (D ** 0.5)
    cdt = torch.bfloat16          # the reference's COMPUTE_DTYPE
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = torch.sum(dof * out.float(), dim=-1).transpose(1, 2)  # [B,H,Sq]
    dk = torch.zeros((B, Skv, H, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Skv, H, D), dtype=torch.float32, device=q.device)
    dqs = []
    for qi in range(Sq // qc):
        rows = slice(qi * qc, (qi + 1) * qc)
        qb, dob = qf[:, rows], dof[:, rows]                       # [B,qc,H,D]
        Li, di = lse[:, :, rows], delta[:, :, rows]               # [B,H,qc]
        dqi = torch.zeros((B, qc, H, D), dtype=torch.float32,
                          device=q.device)
        for ki in range(Skv // kc):
            cols = slice(ki * kc, (ki + 1) * kc)
            kb, vb = kf[:, cols], vf[:, cols]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            if causal:
                s = s + _causal_bias(qi, ki, qc, kc, q.device)[None, None]
            p = torch.exp(s - Li[..., None])                      # [B,H,qc,kc]
            pb = p.to(cdt).float()
            dv[:, cols] += torch.einsum("bhqk,bqhd->bkhd", pb, dob)
            dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb)
            ds = (p * (dp - di[..., None]) * scale).to(cdt).float()
            dqi += torch.einsum("bhqk,bkhd->bqhd", ds, kb)
            dk[:, cols] += torch.einsum("bhqk,bqhd->bkhd", ds, qb)
        dqs.append(dqi)
    dq = torch.cat(dqs, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_attention(q, k, v, *, causal=True):
    """O(S^2) oracle for tests (grouped: H(q) may be a multiple of H(kv))."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (D ** 0.5)
    if causal:
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", w.to(v.dtype).float(), v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
