"""Plain PyTorch Mamba2 SSD scan: the JAX package's chunked oracle
(`models/ssm.py::ssd_chunked`, returning `(y, final_state)`) and its
step-by-step reference, rewritten."""
from __future__ import annotations

import torch

COMPUTE_DTYPE = torch.bfloat16


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
        diff = cs[:, :, None, :] - cs[:, None, :, :]             # [b,l,s,h]
        L = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
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
