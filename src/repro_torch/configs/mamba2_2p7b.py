"""mamba2-2.7b — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                     # attention-free, no FFN: pure Mamba2 blocks
    vocab_size=50280,           # padded to 50432 for TP (see DESIGN.md §5)
    vocab_pad_to=256,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
))
