"""Assigned input shapes and meta-tensor stand-ins per (arch x shape): the
port of the JAX package's `launch/shapes.py`.

input_specs() returns everything a lowering of a cell needs: the step
kind, positional args as meta tensors (shapes and dtypes, no storage),
matching in_shardings (`launch.sharding.NamedSharding` trees), and
donation indices — no device allocation ever happens.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.launch import sharding as S
from repro_torch.models import model as M
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.train.state import train_state_shapes, train_state_shardings


def meta(shape, dtype) -> torch.Tensor:
    """A meta tensor: the port's ShapeDtypeStruct."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPE_TABLE = {
    "train_4k": ShapeCase("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524288, 1),
}


def applicable(cfg, shape_name: str) -> tuple[bool, str]:
    case = SHAPE_TABLE[shape_name]
    if case.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skipped: pure full-attention arch — O(S^2) attention at "
                       "S=524288 is not deployable (DESIGN.md §5)")
    return True, ""


def _batch_struct(cfg, case: ShapeCase, mesh):
    """(batch_dict, batch_sharding_dict) for train/prefill."""
    B, Sq = case.batch, case.seq
    sds: dict[str, Any] = {}
    if cfg.family == "audio":
        sds["embeds"] = meta((B, Sq, cfg.d_model), COMPUTE_DTYPE)
    else:
        sds["tokens"] = meta((B, Sq), torch.int32)
    if case.kind == "train":
        sds["labels"] = meta((B, Sq), torch.int32)
    if cfg.family == "vlm":
        sds["vision_embeds"] = meta((B, cfg.n_vision_tokens, cfg.d_model),
                                    COMPUTE_DTYPE)
    shardings = {k: S.batch_sharding_for(mesh, v) for k, v in sds.items()}
    return sds, shardings


def _meta_tree(spec):
    if isinstance(spec, dict):
        return {k: _meta_tree(v) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return tuple(_meta_tree(v) for v in spec)
    return meta(spec.shape, spec.dtype)


def input_specs(cfg, shape_name: str, mesh, *, grad_compression=False) -> dict:
    """Returns {kind, args, in_shardings, donate_argnums, case}."""
    case = SHAPE_TABLE[shape_name]
    ok, why = applicable(cfg, shape_name)
    if not ok:
        raise ValueError(why)

    if case.kind == "train":
        state_sds = train_state_shapes(cfg, grad_compression=grad_compression)
        state_sh = train_state_shardings(cfg, mesh,
                                         grad_compression=grad_compression)
        batch_sds, batch_sh = _batch_struct(cfg, case, mesh)
        return dict(kind="train", case=case,
                    args=(state_sds, batch_sds),
                    in_shardings=(state_sh, batch_sh),
                    donate_argnums=(0,))

    params_sds = M.param_shapes(cfg)
    params_sh = S.param_sharding_tree(cfg, mesh, params_sds)

    if case.kind == "prefill":
        batch_sds, batch_sh = _batch_struct(cfg, case, mesh)
        return dict(kind="prefill", case=case,
                    args=(params_sds, batch_sds),
                    in_shardings=(params_sh, batch_sh),
                    donate_argnums=())

    # ---- decode: one new token against a seq_len cache ----------------------
    B, Sq = case.batch, case.seq
    cache_sds = _meta_tree(M.make_decode_cache_spec(cfg, B, Sq))
    cache_sh = S.cache_sharding_tree(cfg, mesh, cache_sds)
    tok_sds = meta((B, 1), torch.int32)
    tok_sh = S.batch_sharding_for(mesh, tok_sds, batch_axes=("data",))
    len_sds = meta((), torch.int32)
    args = [params_sds, cache_sds, tok_sds, len_sds]
    shardings = [params_sh, cache_sh, tok_sh, S.replicated(mesh)]
    if cfg.family == "audio":
        emb = meta((B, 1, cfg.d_model), COMPUTE_DTYPE)
        args.append(emb)
        shardings.append(S.batch_sharding_for(mesh, emb, batch_axes=("data",)))
    return dict(kind="decode", case=case, args=tuple(args),
                in_shardings=tuple(shardings), donate_argnums=(1,))
