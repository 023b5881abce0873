"""Exact join-order DP (batched MPDP) on PyTorch tensors."""
