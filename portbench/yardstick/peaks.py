"""Peaks of one NVIDIA H100 SXM (80 GB HBM3).

``HBM_BYTES_S`` is NVIDIA's published HBM3 bandwidth.  ``INT32_OPS_S`` is
not published: it is assumed from the architecture, 132 SMs x 64 INT32
lanes x 1.98 GHz boost clock, and every share that divides by it says so.
Both assume the card's full 700 W power limit.
"""
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
