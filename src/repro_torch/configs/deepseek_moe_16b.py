"""deepseek-moe-16b — 2 shared + 64 routed top-6, fine-grained experts;
layer 0 is dense. [arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                  # fine-grained expert width
    vocab_size=102400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
    dense_d_ff=10944,           # width of the dense first layer
))
