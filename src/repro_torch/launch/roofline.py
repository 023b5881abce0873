"""Roofline terms of a dry-run cell, at one NVIDIA H100's peaks.  The port
of ``repro.launch.roofline``.

  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes accessed / HBM_BW
  collective = collective bytes / LINK_BW

all per device (``launch.dryrun`` divides the step's work by the ways it
is split).  ``collective_bytes`` parses post-optimization HLO text, as
the reference's does, so it still reads the reference's artifacts: the
sum of result-shape bytes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute (ring all-reduce moves
about 2x that: noted, not modelled).  The port's own dry-run builds the
same record from its sharding rules.

Hardware model: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit):
  - ``PEAK_FLOPS`` 989.4 TFLOP/s bf16 on the tensor cores;
  - ``HBM_BW`` 3.35 TB/s, HBM3;
  - ``LINK_BW`` 450 GB/s: NVLink 4 gives 900 GB/s bidirectional a GPU,
    450 GB/s in each direction;
  - ``HBM_BYTES`` 80 GB of HBM3.
The single ``LINK_BW`` assumes every collective stays inside one 8-GPU
NVLink domain.  A 16-wide ``model`` axis spans two 8-GPU nodes and
crosses InfiniBand (NDR, 50 GB/s a GPU), and the ``data`` and ``pod``
axes of the production meshes span nodes too: that is not modelled, so
the collective term is a lower bound there.
"""
from __future__ import annotations

import re

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_BYTES = 80e9

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\S+))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(", re.I)

_SHAPE_RE = re.compile(r"(pred|s8|u8|s16|u16|bf16|f16|s32|u32|f32|s64|u64|f64|c64|c128)\[([0-9,]*)\]")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Sum result bytes per collective kind from post-opt HLO."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for m in _COLL_RE.finditer(hlo_text):
        shape_str = m.group(1) or m.group(2)
        kind = m.group(3).lower()
        out[kind] += _shape_bytes(shape_str)
        out["count"] += 1
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int) -> dict:
    """All three inputs are per device already, so ``chips`` divides
    nothing (kept for the reference's signature)."""
    del chips
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    terms["step_s_lower_bound"] = max(compute_s, memory_s, collective_s)
    return terms


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) useful-training-compute yardstick;
    for serve shapes: 2*N_active per generated token (decode) or per prompt
    token (prefill)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * tokens
