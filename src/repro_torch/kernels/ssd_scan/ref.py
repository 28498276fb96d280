"""Plain PyTorch Mamba2 SSD scan: the JAX package's chunked oracle
(`models/ssm.py::ssd_chunked`, returning `(y, final_state)`) and its
step-by-step reference, rewritten."""
from __future__ import annotations

import torch

COMPUTE_DTYPE = torch.bfloat16


def _masked_decay(cs, tri):
    """L[b,l,s,h] = exp(cs_l - cs_s) where l >= s, else 0. The mask is
    applied before the exp: above the diagonal cs_l - cs_s > 0 can overflow
    to inf, and the JAX package's `where(tri, exp(diff), 0)` then has a NaN
    gradient (0 * inf) though its value is right. The values are the
    same."""
    diff = cs[:, :, None, :] - cs[:, None, :, :]
    return torch.exp(torch.where(tri[None, :, :, None], diff, -torch.inf))


def ssd_chunked(x, dt, A, B, C, D, *, chunk=128, initial_state=None):
    """Chunked SSD scan. x:[b,s,h,p] dt:[b,s,h] (>=0) A:[h] (<0)
    B/C:[b,s,n] D:[h]. Returns (y [b,s,h,p] bf16, final_state [b,h,p,n]
    fp32). All arithmetic in fp32; the chunks are walked in order."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(
            f"sequence length {s} is not divisible by chunk {chunk} — "
            f"the chunked SSD scan needs whole chunks (pad the sequence "
            f"or pick a chunk that divides it)")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    A = A.float()
    D = D.float()

    idx = torch.arange(chunk, device=x.device)
    tri = idx[:, None] >= idx[None, :]                            # [l,s]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dtq * A                                             # [b,q,h] <= 0
        cs = torch.cumsum(dA, dim=1)                             # inclusive
        total = cs[:, -1]                                        # [b,h]
        xdt = xq * dtq[..., None]                                # [b,q,h,p]

        # intra-chunk: masked decay matmul; L = exp of the difference, never
        # exp(cs_l) / exp(cs_s), which underflows
        scores = torch.einsum("bln,bsn->bls", Cq, Bq)            # [b,l,s]
        L = _masked_decay(cs, tri)                               # [b,l,s,h]
        y = torch.einsum("blsh,bshp->blhp", scores[..., None] * L, xdt)

        # contribution of the carried state
        out_decay = torch.exp(cs)                                # [b,q,h]
        y = y + torch.einsum("bln,bhpn->blhp", Cq, state) * out_decay[..., None]

        # state update
        decay_states = torch.exp(total[:, None] - cs)            # [b,q,h]
        upd = torch.einsum("bshp,bsn->bhpn", xdt * decay_states[..., None], Bq)
        state = state * torch.exp(total)[:, :, None, None] + upd

        y = y + D[None, None, :, None] * xq
        ys.append(y.to(COMPUTE_DTYPE))
    return torch.stack(ys, dim=1).reshape(b, s, h, p), state


def split_bf16(v):
    """v as the kernel feeds an fp32 operand to bf16 tensor cores: hi =
    bf16(v), lo = bf16(v - hi), and the product sees hi + lo (~16 bits of
    v; the sum is exact in fp32)."""
    hi = v.to(COMPUTE_DTYPE).float()
    return hi + (v - hi).to(COMPUTE_DTYPE).float()


def ssd_chunked_split(x, dt, A, B, C, D, *, chunk=128, initial_state=None):
    """`ssd_chunked` with the roundings of the CUDA kernel
    (`csrc/ssd_scan.cu`): C.B^T of the bf16 values with fp32 sums; the
    fp32 operand of each other product split into bf16 hi + lo (the
    decay-masked M' = C.B^T * exp(cs_l - cs_s) * dt_s against x, the state
    against C, x * dt exp(cs_last - cs_s) against B); x, B and C enter as
    they are (bf16 on the card). Same contract as `ssd_chunked`."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not divisible by chunk "
                         f"{chunk}")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    A, D = A.float(), D.float()
    idx = torch.arange(chunk, device=x.device)
    tri = idx[:, None] >= idx[None, :]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cs = torch.cumsum(dtq * A, dim=1)                        # [b,q,h]
        total = cs[:, -1]
        G = torch.einsum("bln,bsn->bls", Cq, Bq)
        L = _masked_decay(cs, tri)                               # [b,l,s,h]
        Mp = G[..., None] * L * dtq[:, None, :, :]
        y = torch.einsum("bln,bhpn->blhp", Cq, split_bf16(state)) \
            * torch.exp(cs)[..., None]
        y = y + torch.einsum("blsh,bshp->blhp", split_bf16(Mp), xq)
        fs = dtq * torch.exp(total[:, None] - cs)                # [b,q,h]
        upd = torch.einsum("bshp,bsn->bhpn", split_bf16(xq * fs[..., None]),
                           Bq)
        state = state * torch.exp(total)[:, :, None, None] + upd
        ys.append((y + D[None, None, :, None] * xq).to(COMPUTE_DTYPE))
    return torch.stack(ys, dim=1).reshape(b, s, h, p), state


def ssd_recurrent_reference(x, dt, A, B, C, D, *, initial_state=None):
    """Step-by-step oracle (tests only)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    hidden = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
              if initial_state is None else initial_state.float())
    A, D = A.float(), D.float()
    ys = []
    for t in range(s):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        Bt, Ct = B[:, t].float(), C[:, t].float()
        decay = torch.exp(dtt * A)                               # [b,h]
        upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], Bt)
        hidden = hidden * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hidden, Ct)
                  + D[None, :, None] * xt)
    return torch.stack(ys, dim=1).to(COMPUTE_DTYPE), hidden
