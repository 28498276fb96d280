"""arctic-480b — 128-expert top-2 MoE + dense residual per layer.
[hf:Snowflake/snowflake-arctic-base]

Master params are kept bf16 (f32 Adam moments): 480B params × (2+4+4) B/param
= 4.8 TB → 9.4 GB/chip on 512 chips. f32 masters would not fit 16 GB HBM.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                  # expert FFN width
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    dense_residual=True,        # parallel dense FFN on every layer
    dense_d_ff=4864,
    param_dtype="bfloat16",
))
