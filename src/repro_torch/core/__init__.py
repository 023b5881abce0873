"""Exact join-order DP (solo and batched MPDP) on PyTorch tensors."""
