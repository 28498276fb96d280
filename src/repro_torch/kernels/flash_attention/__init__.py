"""Flash attention forward: CUDA kernel `csrc/flash_attention.cu` and its
plain PyTorch version."""
