"""Shared neural-net building blocks (plain functions on tensors), the port
of the JAX package's `models/layers.py`.

Params are nested dicts of tensors. Compute is bf16 with fp32 accumulation;
master params keep their configured dtype. Every `.to(COMPUTE_DTYPE)` below
stands where the JAX code has an `.astype(COMPUTE_DTYPE)`, so bf16 rounds at
the same points in both packages. JAX einsums with
`preferred_element_type=float32` on bf16 inputs are fp32 products of the
bf16 values here (exact: a product of two bf16 fits in fp32), and fp32
matrix products run in full fp32 (`torch.backends.cuda.matmul.allow_tf32`
is left at its default, False).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.meshctx import BATCH, is_dtensor, local_map, reduce_grad

COMPUTE_DTYPE = torch.bfloat16


# --------------------------------------------------------------------- init
def normal(gen: torch.Generator | None, shape, *, device,
           dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws from `gen` (no draw on the meta device, where
    only shapes exist)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


def _dense_init(gen, shape, *, device, fan_in=None, dtype=torch.float32):
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (normal(gen, shape, device=device) * scale).to(dtype)


def init_linear(gen, d_in, d_out, *, device, bias=False, dtype=torch.float32):
    p = {"w": _dense_init(gen, (d_in, d_out), device=device, fan_in=d_in,
                          dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p, x):
    """bf16 projection: fp32 accumulation inside the product, bf16 in and
    out (`layers.py:28-37` of the JAX package). On DTensors,
    `_sharded_linear`."""
    if is_dtensor(x) or is_dtensor(p["w"]):
        return _sharded_linear(p, x)
    y = torch.matmul(x.to(COMPUTE_DTYPE), p["w"].to(COMPUTE_DTYPE))
    if "b" in p:
        y = y + p["b"].to(COMPUTE_DTYPE)
    return y


def _model_split(w) -> tuple:
    """(in, out): "model" for the dim of weight [d_in, d_out] that its
    placements split over `model`, else None."""
    names = w.device_mesh.mesh_dim_names
    if "model" not in names:
        return None, None
    q = w.placements[names.index("model")]
    if not q.is_shard():
        return None, None
    return ("model", None) if q.dim == 0 else (None, "model")


def _sharded_linear(p, x):
    """The product local to each rank's batch rows, the weight gathered
    whole over `data` (the ZeRO-3 gather) and split over `model` as it
    lies: column-parallel (d_out over `model`) gives the output's features
    over `model`; row-parallel (d_in over `model`) reads x's features over
    `model` and all-reduces its partial sum over it once, in bf16, so the
    output is whole over `model`. The layout XLA's SPMD
    partitioner gives the reference's einsums: DTensor's own choice for a
    matmul of a batch-sharded x and an FSDP-sharded weight sometimes
    gathers the batch instead, and every rank then repeats its rows'
    products."""
    w = p["w"]
    tin, tout = _model_split(w)
    lead = (BATCH,) + (None,) * (x.ndim - 2)
    b = p.get("b")
    bias_in = b is not None and tin is None
    args = (x, w, b) if bias_in else (x, w)
    specs = ((*lead, tin), (tin, tout), (tout,))[:len(args)]
    y = local_map(
        lambda x_, w_, *b_: linear({"w": w_, **({"b": b_[0]} if b_ else
                                                 {})}, x_),
        args, specs, ((*lead, tout),), ((*x.shape[:-1], w.shape[-1]),),
        partial=("model",) if tin else ())
    if b is not None and not bias_in:
        y = y + b.to(COMPUTE_DTYPE)
    return y


# ----------------------------------------------------------------- rmsnorm
def init_rmsnorm(d, *, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p, x, eps=1e-5):
    """The normed `x` in bf16. On a DTensor, the products that read it
    whole over `model` (q, k and v; gate and up; the Mamba2 projections;
    the unembedding) hand back partial gradients, reduced once here
    (`meshctx.reduce_grad`)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return reduce_grad((y * p["scale"].float()).to(COMPUTE_DTYPE))


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None):
    """Inverse frequencies for rotary embeddings; [head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                         # [D/2]
    ang = positions[..., :, None, None].float() * inv            # [...,S,1,D/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(COMPUTE_DTYPE)


# ------------------------------------------------------------------ swiglu
def init_swiglu(gen, d_model, d_ff, *, device, dtype=torch.float32):
    return {
        "gate": init_linear(gen, d_model, d_ff, device=device, dtype=dtype),
        "up": init_linear(gen, d_model, d_ff, device=device, dtype=dtype),
        "down": init_linear(gen, d_ff, d_model, device=device, dtype=dtype),
    }


def swiglu(p, x):
    g = linear(p["gate"], x)
    u = linear(p["up"], x)
    return linear(p["down"], F.silu(g.float()).to(COMPUTE_DTYPE) * u)


# -------------------------------------------------------------- embeddings
def init_embedding(gen, vocab, d_model, *, device, dtype=torch.float32):
    return {"table": (normal(gen, (vocab, d_model), device=device)
                      * 0.02).to(dtype)}


def embed(p, ids):
    """Rows `ids` of the bf16 table. A DTensor table is gathered in its
    sharded layout (`_sharded_embed`)."""
    table = p["table"].to(COMPUTE_DTYPE)
    if not is_dtensor(table):
        return table[ids]
    return _sharded_embed(table, ids)


def _sharded_embed(table, ids):
    """The vocab-parallel lookup of a DTensor table [V, d], under
    `meshctx.local_map`: each rank keeps its rows of the vocab (over
    `model`; `d` gathered whole, as a ZeRO-3 gather of the weight) and
    looks up the ids of its batch shard that fall in them, zeros for the
    others; the all-reduce over `model` (one rank holds each row, so the
    bf16 sum is exact) is the gathered row."""
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    if not is_dtensor(ids):
        ids = _replicated(ids, mesh)
    tp = mesh.size(names.index("model")) if "model" in names else 1
    by_vocab = tp > 1 and table.shape[0] % tp == 0
    rows = table.shape[0] // tp if by_vocab else table.shape[0]
    lo = mesh.get_local_rank(names.index("model")) * rows if by_vocab else 0

    def lookup(t, i):
        loc = i - lo
        ok = (loc >= 0) & (loc < rows)
        return t[torch.where(ok, loc, 0)] * ok[..., None].to(t.dtype)

    return local_map(lookup, (table, ids), (("model", None), (BATCH, None)),
                     ((BATCH, None, None),),
                     ((*ids.shape, table.shape[1]),),
                     partial=("model",) if by_vocab else ())


def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def unembed(p, x):
    """Hidden states -> fp32 logits: the fp32 product of the bf16 values
    (JAX: bf16 einsum with `preferred_element_type=float32`). On DTensors
    the product is local to each rank's batch rows and its slice of the
    vocab (over `model`), the table gathered whole over `data`."""
    if is_dtensor(x) or is_dtensor(p["table"]):
        t = p["table"]
        lead = (BATCH,) + (None,) * (x.ndim - 2)
        return local_map(lambda x_, t_: unembed({"table": t_}, x_),
                         (x, t), ((*lead, None), ("model", None)),
                         ((*lead, "model"),), ((*x.shape[:-1], t.shape[0]),))
    t = p["table"].to(COMPUTE_DTYPE)
    return torch.matmul(x.float(), t.float().t())
