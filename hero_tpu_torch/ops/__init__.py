"""Kernels of the serving and training paths: packed attention (forward
with Philox dropout, backward) and row LayerNorm (forward, backward), each
a CUDA kernel beside its plain PyTorch version."""
