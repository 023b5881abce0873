"""Activation-sharding context.  The port of ``repro.distributed.ctx``.

Models call ``hint(x, kind)`` at key points.  With no mesh active (every
serving and training run of the port) the hint returns ``x`` itself.
With a mesh active (set by the dry-run through ``use(mesh, dp_axes)``)
it resolves ``kind`` to a spec, as the reference does, and appends
``(kind, shape, dtype, spec)`` to the active record; it still returns
``x`` unchanged: the port runs one process and has no sharding
constraint to place, and the dry-run reads the record to model the
activations' collectives.  Specs are sanitized against divisibility per
dim, so e.g. starcoder2's 24 heads simply skip the model-axis split on
the head dim while the merged H*Hd projection dim still gets it.

A spec has one entry per dimension: None (replicated), an axis name, or a
tuple of axis names; a one-axis tuple is written as the axis name, as
``distributed.sharding.NamedSharding`` stores it.
"""
from __future__ import annotations

import contextlib

_STATE = {"mesh": None, "dp": ("data",), "record": None}

# kind -> list of candidate spec builders over (dp_axes); the first whose
# sharded dims all divide evenly wins (e.g. logits prefer vocab-TP, but a
# 49155-vocab falls back to sequence-TP instead of replicating 30 GB)
_KINDS = {
    "act": [lambda dp: (dp, None, None)],        # (B, S, D) residual stream
    "proj": [lambda dp: (dp, None, "model")],    # (B, S, H*Hd | 2F) col out
    "logits": [lambda dp: (dp, None, "model"),   # (B, S, V) vocab-TP
               lambda dp: (dp, "model", None)],  #           seq-TP fallback
    "logits2d": [lambda dp: (dp, "model"), lambda dp: (dp, None)],
    "vec": [lambda dp: (dp, None)],              # (B, S) per-token scalars
    "expert": [lambda dp: ("model", None, None)],  # (E, C, D) MoE dispatch
}


def activate(mesh, dp_axes, record=None) -> list:
    """Make ``mesh`` active; hints append to ``record`` (a new list if
    None), which is returned."""
    _STATE["mesh"] = mesh
    _STATE["dp"] = tuple(dp_axes)
    _STATE["record"] = [] if record is None else record
    return _STATE["record"]


def deactivate():
    _STATE["mesh"] = None


@contextlib.contextmanager
def use(mesh, dp_axes, record=None):
    """``activate`` for the ``with`` block, yielding the record; the state
    before it is restored after."""
    old = dict(_STATE)
    try:
        yield activate(mesh, dp_axes, record)
    finally:
        _STATE.update(old)


def _axis_size(mesh, axes):
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= mesh.shape[a]
    return s


def _canonical(axes):
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def resolve(shape, kind: str, mesh, dp_axes) -> tuple:
    """The reference's spec for a hint of ``kind`` on a tensor of
    ``shape``: the first candidate whose sharded dims all divide evenly,
    else the first candidate with the uneven dims replicated."""
    ndim = len(shape)
    best = None
    for builder in _KINDS[kind]:
        spec = builder(tuple(dp_axes))
        out = []
        clean = True
        for d, axes in enumerate(spec):
            if d >= ndim:
                break
            if axes is not None and shape[d] % _axis_size(mesh, axes) == 0:
                out.append(axes)
            else:
                out.append(None)
                clean = clean and axes is None
        out += [None] * (ndim - len(out))
        if best is None:
            best = out
        if clean:
            best = out
            break
    return tuple(_canonical(a) for a in best)


def hint(x, kind: str):
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    shape = tuple(x.shape)
    _STATE["record"].append((kind, shape, x.dtype,
                             resolve(shape, kind, mesh, _STATE["dp"])))
    return x
