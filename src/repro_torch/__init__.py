"""PyTorch/CUDA port of the massively parallel join optimizer.

Mirrors the layout of the JAX package ``repro`` (``repro_torch.core.batch``
is the counterpart of ``repro.core.batch``, and so on) and imports neither
JAX nor anything of ``repro``.  The exact DP, batched
(``core.batch.optimize_many``) and solo (``core.engine.optimize``), runs
on ``cuda`` by default; its seven per-lane bit-twiddling kernels are
hand-written CUDA C++ for Hopper (``kernels/csrc/ccp_eval.cu``), with
plain PyTorch versions in ``kernels/ref.py`` that serve tensors on the
CPU.
"""
