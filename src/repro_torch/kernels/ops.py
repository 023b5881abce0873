"""Wrappers of the CUDA kernels, with launch counters.

Each wrapper takes int32 lane tensors and an adjacency table: one query's
``int32[nmax]`` for the solo-engine kernels (``connectivity``,
``ccp_eval``, ``grow_pair``), the stacked ``int32[bcap, nmax]`` for the
batched ones.  Tensors on the CPU go to the plain PyTorch version in
``ref``; tensors on a CUDA device go to the kernel, or the wrapper raises
(wrong dtype, shape, layout or mixed devices, or a refused launch).  There
is no fallback from one to the other.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.

Kernels run on PyTorch's current stream, the stream the caching allocator
orders frees on, so an input tensor the caller drops right after the call
is not reused before the kernel has read it.
"""
from __future__ import annotations

import torch

from . import build, ref

LAUNCHES = {"connectivity": 0, "ccp_eval": 0, "grow_pair": 0,
            "bconnectivity": 0, "bccp_eval": 0, "btree_eval": 0,
            "bgeneral_eval": 0}
_SINGLE = ("connectivity", "ccp_eval", "grow_pair")   # one (nmax,) table
_SMEM_LIMIT = 48 * 1024       # static dynamic-shared-memory budget per block


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(name: str, lanes, adj) -> bool:
    devs = {t.device for t in (*lanes, adj)}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def _launch(name: str, lanes, adj, nmax: int, n_out: int):
    """Check the inputs, allocate outputs and launch ``rt_<name>``."""
    L = lanes[0].numel()
    for t in lanes:
        if t.dtype != torch.int32 or t.dim() != 1 or t.numel() != L \
                or not t.is_contiguous():
            raise ValueError(f"{name}: lanes must be contiguous int32[{L}], "
                             f"got {t.dtype}{tuple(t.shape)}")
    single = name in _SINGLE
    if adj.dtype != torch.int32 or adj.dim() != (1 if single else 2) \
            or adj.shape[-1] != nmax or not adj.is_contiguous():
        spec = f"[{nmax}]" if single else f"[bcap, {nmax}]"
        raise ValueError(f"{name}: {'adj' if single else 'adj_b'} must be "
                         f"contiguous int32{spec}, got {adj.dtype}{tuple(adj.shape)}")
    bcap = 1 if single else adj.shape[0]
    if not 1 <= nmax <= 30 or bcap < 1 or bcap * nmax * 4 > _SMEM_LIMIT:
        raise ValueError(f"{name}: unsupported table shape {tuple(adj.shape)}")
    outs = [torch.empty_like(lanes[0]) for _ in range(n_out)]
    if L == 0:
        return outs
    lib = build.library()
    stream = torch.cuda.current_stream(lanes[0].device).cuda_stream
    dims = (L, nmax) if single else (L, bcap, nmax)
    rc = getattr(lib, f"rt_{name}")(
        *[t.data_ptr() for t in lanes], adj.data_ptr(),
        *[o.data_ptr() for o in outs], *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{lib.rt_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    return outs


# -- solo engine ---------------------------------------------------------------

def connectivity(S, adj, nmax: int):
    """int32 1 where G[S] is connected."""
    if _on_cpu("connectivity", (S,), adj):
        return ref.connectivity_ref(S, adj, nmax)
    return _launch("connectivity", (S,), adj, nmax, 1)[0]


def ccp_eval(S, sub, adj, nmax: int):
    """DPSUB lanes -> (lb, rb, ccp int32)."""
    if _on_cpu("ccp_eval", (S, sub), adj):
        return ref.ccp_eval_ref(S, sub, adj, nmax)
    return tuple(_launch("ccp_eval", (S, sub), adj, nmax, 3))


def grow_pair(S, lb, rb, adj, nmax: int):
    """MPDP-general lanes -> (S_left, S_right)."""
    if _on_cpu("grow_pair", (S, lb, rb), adj):
        return ref.grow_pair_ref(S, lb, rb, adj, nmax)
    return tuple(_launch("grow_pair", (S, lb, rb), adj, nmax, 2))


# -- batched engine ------------------------------------------------------------

def bconnectivity(S, qid, adj_b, nmax: int):
    """int32 1 where G_q[S] is connected (q = qid of the lane)."""
    if _on_cpu("bconnectivity", (S, qid), adj_b):
        return ref.bconnectivity_ref(S, qid, adj_b, nmax)
    return _launch("bconnectivity", (S, qid), adj_b, nmax, 1)[0]


def bccp_eval(S, sub, qid, adj_b, nmax: int):
    """Batched DPSUB lanes -> (lb, rb, ccp int32)."""
    if _on_cpu("bccp_eval", (S, sub, qid), adj_b):
        return ref.bccp_eval_ref(S, sub, qid, adj_b, nmax)
    return tuple(_launch("bccp_eval", (S, sub, qid), adj_b, nmax, 3))


def btree_eval(S, ub, vb, qid, adj_b, nmax: int):
    """Batched MPDP:Tree lanes -> (S_left, edge_in int32)."""
    if _on_cpu("btree_eval", (S, ub, vb, qid), adj_b):
        return ref.btree_eval_ref(S, ub, vb, qid, adj_b, nmax)
    return tuple(_launch("btree_eval", (S, ub, vb, qid), adj_b, nmax, 2))


def bgeneral_eval(S, block, r, qid, adj_b, nmax: int):
    """Batched MPDP-general lanes -> (lb, S_left, ccp int32)."""
    if _on_cpu("bgeneral_eval", (S, block, r, qid), adj_b):
        return ref.bgeneral_eval_ref(S, block, r, qid, adj_b, nmax)
    return tuple(_launch("bgeneral_eval", (S, block, r, qid), adj_b, nmax, 3))
