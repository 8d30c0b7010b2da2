"""Hand-written CUDA kernels, their builds and their plain PyTorch versions."""
