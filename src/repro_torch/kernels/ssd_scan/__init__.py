"""Mamba2 SSD chunked scan: CUDA kernel `csrc/ssd_scan.cu` and its plain
PyTorch version."""
