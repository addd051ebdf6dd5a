"""Kernels of the serving path: packed attention and row LayerNorm, each a
CUDA kernel beside its plain PyTorch version."""
