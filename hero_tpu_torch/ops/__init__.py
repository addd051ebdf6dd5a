"""Kernels of the serving, training and component paths: attention (the
packed forward with Philox dropout and its backward; the head-major
forward and its backward), row LayerNorm (forward, backward) and the
fused dropout-add-LayerNorm (forward, backward), each a CUDA kernel
beside its plain PyTorch version."""
