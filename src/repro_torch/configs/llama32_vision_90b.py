"""llama-3.2-vision-90b — cross-attention image layers every 5 layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

Backbone only: the vision tower is a STUB — input_specs() provides
precomputed patch embeddings [B, n_vision_tokens, d_model].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_interval=5,      # every 5th layer gets a cross-attn sublayer
    n_vision_tokens=1600,
))
