"""Sharding rules: the DP lane partitioner + LLM param/batch/cache specs.
The port of ``repro.distributed.sharding``.

``partition_lanes`` splits one DP level's lane space (DPSUB ``sets x 2^i``
lanes, MPDP:Tree ``sets x m`` lanes, the MPDP-general block prefix-sum, or
the filter's colex ranks) into contiguous, balanced per-shard ranges.
Contiguity matters twice over: filter output concatenated in shard order
stays in global (colex-ascending) set order, and evaluate chunks keep
monotone segment ids, so the in-chunk segment prunes stay valid.

The rest is the reference's parameter / batch / cache rules for the
training and serving stack (DP+FSDP x TP x EP x SP), spec for spec:

  embeddings       (V, D)        -> (model, data)    vocab-TP + FSDP
  attn in-proj     (L, D, H*Hd)  -> (_, data, model) Megatron column
  attn out-proj    (L, H*Hd, D)  -> (_, model, data) Megatron row
  MLP in / out     analogous column/row
  MoE experts      (L, E, D, F)  -> (_, model, data, _)   expert parallelism
  SSM/LRU mixers   channel dims over model, D over data
  norms/gates      replicated

A spec is a tuple with one entry per dimension: None (replicated), an
axis name, or a tuple of axis names; a ``NamedSharding``'s spec equals
the tuple of the reference's ``PartitionSpec``.  Every preferred spec is sanitized against
the mesh: a dimension that does not divide evenly is replicated.  The
port runs one process: placing a leaf puts it whole on the mesh's first
device (a mesh's shards are logical shards of one card), and the spec is
kept for a reader of the layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..launch.mesh import dp_axes
from ..tree import tree_map, tree_map_with_path


# ---------------------------------------------------- DP lane partitioner --

def partition_lanes(total: int, parts: int) -> np.ndarray:
    """Balanced contiguous partition of ``[0, total)`` into ``parts`` ranges.

    Returns int64 offsets of shape ``(parts + 1,)``: part ``d`` owns lanes
    ``[offsets[d], offsets[d + 1])``.  The first ``total % parts`` parts get
    one extra lane, so sizes differ by at most one; ``total == 0`` yields
    ``parts`` empty ranges.
    """
    if parts < 1:
        raise ValueError(f"need at least 1 partition, requested {parts}")
    if total < 0:
        raise ValueError(f"negative lane total {total}")
    base, rem = divmod(int(total), parts)
    sizes = np.full(parts, base, np.int64)
    sizes[:rem] += 1
    offs = np.zeros(parts + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    return offs


# ------------------------------------------------------------ mesh helpers --

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on a mesh: ``spec`` per dimension (see the module
    docstring), in ``PartitionSpec``'s canonical form: a one-axis tuple is
    stored as the axis name."""
    mesh: object
    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, "spec", tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in self.spec))

    @property
    def device(self):
        """Where the port places the leaf: the mesh's first device."""
        if self.mesh.devices is None:
            raise ValueError(f"{self.mesh!r} is abstract: it has no devices")
        return self.mesh.devices[0]


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= mesh.shape[a]
    return s


def sanitize(spec: tuple, shape, mesh) -> tuple:
    out = []
    for d, axes in enumerate(spec):
        if axes is None or d >= len(shape):
            out.append(None)
            continue
        if shape[d] % _axis_size(mesh, axes) == 0:
            out.append(axes)
        else:
            out.append(None)
    return tuple(out)


# ------------------------------------------------------------- param rules --

def param_spec(path: str, shape) -> tuple:
    r = len(shape)
    if "embed" in path:
        return ("model", "data")
    if "patch_proj" in path or "frame_proj" in path:
        return (None, "model")
    if "router" in path:
        return (None, "data", None)
    if "shared_wi" in path:
        return (None, "data", "model")
    if "shared_wo" in path:
        return (None, "model", "data")
    if r == 4:                         # MoE experts (L, E, D, F)/(L, E, F, D)
        if path.endswith("wi"):
            return (None, "model", "data", None)
        return (None, "model", None, "data")
    if r == 3:
        last = path.rsplit("/", 1)[-1]
        if last in ("wq", "wk", "wv", "wi", "w_x", "w_gate", "in_proj"):
            return (None, "data", "model")        # column parallel
        if last in ("wo", "w_out", "out_proj", "w_uk", "w_uv"):
            return (None, "model", "data")        # row parallel
        if last == "w_dkv":
            return (None, "data", None)           # MLA latent down-proj
        return (None, None, "model")              # conv_w and the rest
    if r == 2:
        last = path.rsplit("/", 1)[-1]
        if last in ("a_log", "d_skip", "dt_bias", "lam"):
            return (None, "model")
        return (None, None)                       # stacked norms: replicate
    return (None,) * r


def param_shardings(param_tree, mesh):
    """Tree of NamedSharding matching param_tree (meta tensors will do)."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, sanitize(param_spec(path, leaf.shape), leaf.shape, mesh)),
        param_tree)


def state_shardings(state_tree, mesh):
    """TrainState {params, m, v, step}: m/v mirror params; step replicated."""
    return {
        "params": param_shardings(state_tree["params"], mesh),
        "m": param_shardings(state_tree["m"], mesh),
        "v": param_shardings(state_tree["v"], mesh),
        "step": NamedSharding(mesh, ()),
    }


# ------------------------------------------------------------- batch rules --

def batch_shardings(batch_tree, mesh):
    dp = dp_axes(mesh)

    def spec(leaf):
        shape = leaf.shape
        s = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % _axis_size(mesh, dp) == 0:
            s[0] = dp
        return NamedSharding(mesh, tuple(s))

    return tree_map(spec, batch_tree)


def cache_shardings(cache_tree, mesh):
    """Serving caches: dim0 is the stacked-layer dim (replicated); batch over
    dp when divisible; the longest remaining dim (sequence / channel) over
    `model` when divisible (SP fallback for MQA/MLA)."""
    dp = dp_axes(mesh)
    dpn = _axis_size(mesh, dp)
    mn = mesh.shape["model"]

    def spec(leaf):
        shape = leaf.shape
        s = [None] * len(shape)
        batch_sharded = len(shape) >= 2 and shape[1] % dpn == 0
        if batch_sharded:
            s[1] = dp
        # largest dim >= 2 goes over the model axis; when the batch cannot
        # be sharded (long context, B = 1) the idle data axes fold in too
        long_axes = "model" if batch_sharded else tuple(dp) + ("model",)
        n_need = mn if batch_sharded else mn * dpn
        cand = sorted(range(2, len(shape)), key=lambda d: -shape[d])
        for d in cand:
            if shape[d] % n_need == 0 and shape[d] >= n_need:
                s[d] = long_axes
                break
            if not batch_sharded and shape[d] % mn == 0 and shape[d] >= mn:
                s[d] = "model"
                break
        return NamedSharding(mesh, tuple(s))

    return tree_map(spec, cache_tree)


def logits_sharding(mesh, vocab: int, batch: int = 0):
    dp = dp_axes(mesh)
    s_b = dp if batch and batch % _axis_size(mesh, dp) == 0 else None
    s_v = "model" if vocab % mesh.shape["model"] == 0 else None
    return NamedSharding(mesh, (s_b, s_v))


def replicated(mesh):
    return NamedSharding(mesh, ())
