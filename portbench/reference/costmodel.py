"""The PostgreSQL-like cost model of the MPDP paper (§7.1), computed in a
chosen precision.

    scan(R)        = C_SEQ * rows(R)
    hash(l, r)     = C_HASH_BUILD * min(l, r) + C_HASH_PROBE * max(l, r)
                     + C_TUP * out
    merge(l, r)    = C_SORT * (l * lg l + r * lg r) + C_MERGE * (l + r)
                     + C_TUP * out,  lg x = max(log2 x, 1)
    nestloop(l, r) = C_NL * l * r + C_TUP * out
    join(l, r)     = min(hash, merge, nestloop)

Rows are carried as log2 and clamped at 2**LOG2_CAP; the log2 rows of a
relation set are the sum of its relations' log2 cardinalities and of the
log2 selectivities of the edges inside it, floored at 0.

``Precision("f64")`` is the reference.  ``Precision("bf16")`` rounds the
result of every operation to bfloat16 (round to nearest even), the
precision one step below the float32 that the configurations state; it
is the control that a comparison has to reject.
"""
from __future__ import annotations

import numpy as np

C_SEQ = 0.35
C_HASH_BUILD = 1.8
C_HASH_PROBE = 0.55
C_MERGE = 0.4
C_SORT = 0.25
C_NL = 0.02
C_TUP = 0.05
LOG2_CAP = 100.0


def to_bf16(x) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even); the
    result is float32 holding bfloat16 values."""
    a = np.asarray(x, np.float32)
    b = np.ascontiguousarray(a).reshape(-1).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    out = b.astype(np.uint32).view(np.float32).reshape(a.shape)
    # NaN stays NaN (the rounding could carry into the exponent's top)
    return np.where(np.isnan(a), a, out)


class Precision:
    """Arithmetic in float64 (``"f64"``) or emulated bfloat16 (``"bf16"``)."""

    def __init__(self, name: str):
        if name not in ("f64", "bf16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = np.float64 if name == "f64" else np.float32

    def r(self, x):
        """Round an intermediate result to this precision."""
        if self.name == "f64":
            return np.asarray(x, np.float64)
        return to_bf16(x)

    def c(self, v: float):
        return self.r(np.asarray(v, self.dtype))

    # ------------------------------------------------------------ model --
    def rows(self, rl2):
        r = self.r
        return r(np.exp2(r(np.minimum(rl2, self.c(LOG2_CAP)))))

    def scan_cost(self, rl2):
        return self.r(self.c(C_SEQ) * self.rows(rl2))

    def join_cost(self, rl2_l, rl2_r, rl2_out):
        r, c = self.r, self.c
        rl, rr, ro = self.rows(rl2_l), self.rows(rl2_r), self.rows(rl2_out)
        tup = r(c(C_TUP) * ro)
        hj = r(r(r(c(C_HASH_BUILD) * np.minimum(rl, rr))
                 + r(c(C_HASH_PROBE) * np.maximum(rl, rr))) + tup)
        lg_l = np.maximum(rl2_l, c(1.0))
        lg_r = np.maximum(rl2_r, c(1.0))
        mj = r(r(r(c(C_SORT) * r(r(rl * lg_l) + r(rr * lg_r)))
                 + r(c(C_MERGE) * r(rl + rr))) + tup)
        nl = r(r(c(C_NL) * r(np.exp2(r(np.minimum(r(rl2_l + rl2_r),
                                                  c(LOG2_CAP))))))
               + tup)
        return np.minimum(hj, np.minimum(mj, nl))

    def rows_l2(self, sets, wire) -> np.ndarray:
        """log2 rows of each relation set (int64 bitmaps) of the query."""
        sets = np.asarray(sets, np.int64)
        r = self.r
        cards = np.asarray(wire["cards_l2"], self.dtype)
        sels = np.asarray(wire["sels_l2"], self.dtype)
        acc = np.zeros(sets.shape, self.dtype)
        for v in range(wire["n"]):
            acc = r(acc + np.where((sets >> v) & 1 == 1, cards[v], 0))
        for i, (u, v) in enumerate(wire["edges"]):
            inside = ((sets >> u) & 1 == 1) & ((sets >> v) & 1 == 1)
            acc = r(acc + np.where(inside, sels[i], 0))
        return np.maximum(acc, self.c(0.0))


F64 = Precision("f64")
BF16 = Precision("bf16")
