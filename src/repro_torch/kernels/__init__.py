"""Hand-written CUDA kernels for the exact DP (solo and batched), their build, wrappers and
plain PyTorch versions."""
