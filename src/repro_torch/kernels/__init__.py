"""Hand-written CUDA kernels for the batched DP, their build, wrappers and
plain PyTorch versions."""
