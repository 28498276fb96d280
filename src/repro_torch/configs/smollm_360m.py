"""smollm-360m — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]

H=15 / kv=5 do not divide the 16-way model axis: attention runs replicated
over `model` (FFN + embeddings carry the TP) — see launch/sharding.py.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
))
