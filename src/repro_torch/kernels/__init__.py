"""Hand-written CUDA kernels of the port (sources in `csrc/`), each beside
its plain PyTorch version (`ref.py`), which CPU tensors take."""
