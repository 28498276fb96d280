"""Plain PyTorch particle spawn — the same operations as the JAX package's
`pic/particles.py::spawn`, the oracle of the spawn kernel."""
from __future__ import annotations

import torch


def spawn_ref(x, v, w, alive, new_x, new_v, new_w, mask):
    """x, w, alive: [C]; v: [C, 3]; new_x, new_w, mask: [M]; new_v: [M, 3].
    The k-th event of `mask` goes to the k-th slot of a stable argsort of
    `alive` (dead slots first), for k below the dead count; the rest are
    dropped. Returns (x, v, w, alive, dropped), out of place."""
    C = x.shape[0]
    dead_order = torch.argsort(alive, stable=True)     # dead slots first
    k = torch.cumsum(mask.to(torch.int32), 0) - 1      # rank among events
    n_dead = torch.sum(alive <= 0)
    ok = mask & (k < n_dead)
    slot = dead_order[torch.clamp(k, 0, C - 1)]
    slot = torch.where(ok, slot, C)                    # C = trash slot
    # rejected events all write slot C, which is cut off below
    x = torch.cat([x, x.new_zeros(1)])
    v = torch.cat([v, v.new_zeros(1, 3)])
    w = torch.cat([w, w.new_zeros(1)])
    al = torch.cat([alive, alive.new_zeros(1)])
    x[slot] = new_x
    v[slot] = new_v
    w[slot] = new_w
    al[slot] = 1.0
    dropped = torch.sum(mask & ~ok)
    return x[:C], v[:C], w[:C], al[:C], dropped
