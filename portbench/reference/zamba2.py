"""Plain float32 PyTorch reference of the repository's zamba2 hybrid and
its train step: the loss, its gradients, the clip at global norm and
AdamW, from a parameter tree laid out as the program keeps it (nested
dicts and lists of tensors).

The model, from the layer equations and not from the code under test,
whose modules it never imports:
- tokens -> rows of `embed.table`;
- `stack.units[u][i]`, `n_layers` Mamba2 layers in units of
  `shared_attn_interval`; each layer adds `mamba2(rms_norm(x))` to x:
  projections z, x, B, C, dt of the normed input; a depthwise causal
  conv of width `ssm_conv` and silu on each of x, B and C;
  dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD scan in its
  quadratic form over the whole sequence,
  y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < r <= t} dt_r A) dt_s x_s
  + D x_t, each head on its own; y gated by silu(z), RMS-normed and
  projected back;
- after each unit the one shared block: x += attention(rms_norm(x)),
  causal, RoPE (halves rotated, theta `rope_theta`) on q and k, k and v
  heads repeated to the q heads; then x += swiglu(rms_norm(x));
- the final RMS norm, logits against `lm_head.table`, cross-entropy
  over the labels >= 0.
Every product is float32; TF32 is off. The stack's units are
checkpointed (`torch.utils.checkpoint`): a unit's input is kept and the
unit computed again in the backward, so the reference fits one card at
full width beside the program's state.

Zyphra's published Zamba2 (arXiv:2411.15242) differs, and so does the
repository's model, which this file follows: Zyphra alternates two
shared blocks (`num_mem_blocks` 2), feeds each the hidden state
concatenated with the original embedding (attention 2 x hidden wide),
puts rank-128 LoRA adapters on the shared MLP at each invocation and a
linear of its own after each invocation; the model here has one shared
block over `d_model` and none of these.

The step: gradients of the loss; scale min(1, clip / global L2 norm);
AdamW with bias correction at step + 1, decoupled weight decay on the
leaves the program decays (every leaf of the stacked units and every
leaf of rank >= 2), the rate warmed up linearly and then cosine-decayed
to `min_lr_ratio` of it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Dims:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    ssm_state: int
    ssm_expand: int
    ssm_headdim: int
    ssm_conv: int
    shared_attn_interval: int
    head_dim: int = 0
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0

    @classmethod
    def of(cls, model: dict) -> "Dims":
        """From a configuration's `model` numbers; others are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in model.items()
                      if k in names and v is not None})

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float
    warmup_steps: int
    total_steps: int
    min_lr_ratio: float

    def rate(self, step: int) -> float:
        """The learning rate of the update made at `step`."""
        warm = min(step / max(self.warmup_steps, 1), 1.0)
        t = min(max((step - self.warmup_steps)
                    / max(self.total_steps - self.warmup_steps, 1), 0.0),
                1.0)
        cos = self.min_lr_ratio + (1 - self.min_lr_ratio) * 0.5 * (
            1 + math.cos(math.pi * t))
        return self.lr * warm * cos


# ------------------------------------------------------------------ trees
def named(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(named(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(named(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def rebuilt(like, leaves: dict, prefix: str = ""):
    """A tree of `like`'s structure whose leaves are `leaves[path]`."""
    if isinstance(like, dict):
        return {k: rebuilt(v, leaves, f"{prefix}{k}.")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [rebuilt(v, leaves, f"{prefix}{i}.")
                for i, v in enumerate(like)]
    return leaves[prefix[:-1]]


def decayed(name: str, leaf) -> bool:
    """Whether AdamW decays the leaf: the program stacks the units' leaves
    [U, I, ...] and decays every leaf of rank >= 2 so stacked."""
    return name.startswith("stack.units.") or leaf.ndim >= 2


# ------------------------------------------------------------------ model
def rms_norm(p, x, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * p["scale"]


def causal_conv(conv, x):
    """Depthwise causal conv of x [b, s, c] with taps w [k, c], bias, silu."""
    w = conv["w"]
    k, s = w.shape[0], x.shape[1]
    padded = F.pad(x, (0, 0, k - 1, 0))
    return F.silu(sum(padded[:, i:i + s] * w[i] for i in range(k))
                  + conv["b"])


def ssd(x, dt, A, B, C, D):
    """x [b, s, h, p], dt [b, s, h], A and D [h], B and C [b, s, n] ->
    y [b, s, h, p], the quadratic form over the whole sequence."""
    s = x.shape[1]
    cs = torch.cumsum(dt * A, dim=1)                          # [b, s, h]
    t = torch.arange(s, device=x.device)
    causal = (t[:, None] >= t[None, :])[None, :, :, None]     # [1, t, s, 1]
    diff = cs[:, :, None, :] - cs[:, None, :, :]              # [b, t, s, h]
    # masked before the exp: above the diagonal the difference may
    # overflow, and 0 * inf would reach the gradient
    decay = torch.exp(torch.where(causal, diff, -torch.inf))
    scores = torch.einsum("btn,bsn->bts", C, B)
    y = torch.einsum("btsh,bshp->bthp", scores[..., None] * decay,
                     x * dt[..., None])
    return y + D[:, None] * x


def mamba2(p, u, d: Dims):
    b, s, _ = u.shape
    z = u @ p["wz"]["w"]
    x = causal_conv(p["conv_x"], u @ p["wx"]["w"])
    B = causal_conv(p["conv_B"], u @ p["wB"]["w"])
    C = causal_conv(p["conv_C"], u @ p["wC"]["w"])
    dt = F.softplus(u @ p["wdt"]["w"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(x.reshape(b, s, d.ssm_heads, d.ssm_headdim), dt, A, B, C, p["D"])
    y = rms_norm(p["norm"], y.reshape(b, s, d.d_inner) * F.silu(z),
                 d.norm_eps)
    return y @ p["out_proj"]["w"]


def rope(x, theta: float):
    """x [b, s, h, hd]: each half-pair rotated by position * theta^(-2i/hd)."""
    hd, s = x.shape[-1], x.shape[1]
    inv = theta ** -(torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, d: Dims):
    b, s, dm = x.shape
    H, Hkv, hd = d.n_heads, d.n_kv_heads, d.hd

    def heads(w, n):
        return (x @ w.reshape(dm, n * hd)).reshape(b, s, n, hd)

    q = rope(heads(p["wq"]["w"], H), d.rope_theta)
    k = rope(heads(p["wk"]["w"], Hkv), d.rope_theta)
    v = heads(p["wv"]["w"], Hkv)
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    t = torch.arange(s, device=x.device)
    scores = scores.masked_fill(t[None, :] > t[:, None], -torch.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return o.reshape(b, s, H * hd) @ p["wo"]["w"].reshape(H * hd, dm)


def swiglu(p, x):
    return (F.silu(x @ p["gate"]["w"]) * (x @ p["up"]["w"])) @ p["down"]["w"]


def unit(layers, shared, x, d: Dims):
    for lp in layers:
        x = x + mamba2(lp["mamba"], rms_norm(lp["norm"], x, d.norm_eps), d)
    x = x + attention(shared["attn"],
                      rms_norm(shared["attn_norm"], x, d.norm_eps), d)
    return x + swiglu(shared["ffn"],
                      rms_norm(shared["ffn_norm"], x, d.norm_eps))


def loss(params, tokens, labels, d: Dims):
    """Mean cross-entropy over the labels >= 0; each unit checkpointed."""
    x = params["embed"]["table"][tokens.long()]
    shared = params["stack"]["shared"]
    for layers in params["stack"]["units"]:
        x = checkpoint(unit, layers, shared, x, d, use_reentrant=False)
    x = rms_norm(params["final_norm"], x, d.norm_eps)
    logits = x @ params["lm_head"]["table"].t()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), ignore_index=-100)


def loss_and_grads(params, batch: dict, d: Dims):
    """(loss, {path: gradient}) at float32 copies of `params`' leaves."""
    leaves = {k: v.detach().float().requires_grad_()
              for k, v in named(params).items()}
    with torch.enable_grad():
        value = loss(rebuilt(params, leaves), batch["tokens"],
                     batch["labels"], d)
        grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


def clip_scale(grads: dict, clip: float) -> float:
    norm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
    return min(clip / max(norm, 1e-9), 1.0)


def adamw_leaf(hp: AdamW, step: int, scale: float, decay: bool, p, g, m, v):
    """(p, m, v) after one update of one leaf at `step` (0 the first),
    from its clipped gradient `g * scale`."""
    g = g * scale
    m = hp.b1 * m + (1 - hp.b1) * g
    v = hp.b2 * v + (1 - hp.b2) * g.square()
    t = step + 1
    delta = (m / (1 - hp.b1 ** t)) / (
        torch.sqrt(v / (1 - hp.b2 ** t)) + hp.eps)
    if decay:
        delta = delta + hp.weight_decay * p
    return p - hp.rate(step) * delta, m, v
