"""Architecture configuration registry (own copy of the JAX package's
`configs/base.py`: the same dataclass, registry and smoke reduction).

One config per architecture, exact to its published widths; reduced smoke
variants are derived mechanically so tests exercise the same code path at
laptop scale. The parameter count is the port's own shape arithmetic
(`repro_torch.models.model.count_params_analytic`), which allocates nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention details -------------------------------------------------
    head_dim: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 10_000.0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0        # deepseek-moe: 2 shared experts
    dense_residual: bool = False     # arctic: parallel dense FFN on every layer
    first_dense_layers: int = 0      # deepseek-moe: layer 0 is dense
    dense_d_ff: int = 0              # d_ff of the dense layers/residual path
    capacity_factor: float = 1.25

    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (zamba2): shared attention block every k layers -------------
    shared_attn_interval: int = 0

    # --- vlm: cross-attention to vision tokens every k layers ---------------
    cross_attn_interval: int = 0
    n_vision_tokens: int = 0

    # --- audio (musicgen): EnCodec codebooks (frontend stub) ----------------
    n_codebooks: int = 0

    # --- numerics / misc -----------------------------------------------------
    norm_eps: float = 1e-5
    vocab_pad_to: int = 128          # pad vocab so TP divides it
    tie_embeddings: bool = False
    param_dtype: str = "float32"     # master params; compute is bf16

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def supports_long_context(self) -> bool:
        """True when decode cost is sub-quadratic in context (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (matches init_params; used for 6ND)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def n_active_params(self) -> int:
        """Parameters a token uses: the routed experts count top_k of
        n_experts."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} for "
                         f"{cfg.name!r}; known families: {FAMILIES}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in (
        "zamba2_2p7b", "mamba2_2p7b", "phi3_mini_3p8b", "smollm_360m",
        "qwen3_4b", "qwen1p5_0p5b", "musicgen_large", "arctic_480b",
        "deepseek_moe_16b", "llama32_vision_90b",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Scale a config down to laptop size, preserving its family structure."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32 if cfg.head_dim else None,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), dense_d_ff=256 if cfg.dense_d_ff else 0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=32)
    if cfg.shared_attn_interval:
        kw.update(shared_attn_interval=2, n_layers=4)
    if cfg.cross_attn_interval:
        kw.update(cross_attn_interval=2, n_layers=4, n_vision_tokens=16)
    if cfg.first_dense_layers:
        kw.update(n_layers=max(kw["n_layers"], cfg.first_dense_layers + 1))
    return dataclasses.replace(cfg, **kw)
