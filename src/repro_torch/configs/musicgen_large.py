"""musicgen-large — decoder-only over EnCodec tokens. [arXiv:2306.05284]

Backbone only: the EnCodec frontend is a STUB — input_specs() provides
precomputed frame embeddings (sum of n_codebooks embedding lookups).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
))
