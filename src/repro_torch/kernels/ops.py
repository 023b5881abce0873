"""Wrappers of the CUDA kernels, with launch counters.

Each wrapper takes int32 lane tensors and an adjacency table: one query's
``int32[nmax]`` for the solo-engine kernels (``connectivity``,
``ccp_eval``, ``grow_pair``), the stacked ``int32[bcap, nmax]`` for the
batched ones.  Six forms build their lanes in the kernel instead:
``connectivity_span`` unranks a span of colex ranks (the solo filter of
one level), ``ccp_eval_dpsub`` decodes a DPSUB chunk's lanes from the
level's set list, ``bconnectivity_span`` unranks a level span of every
query of a flight (the batched filter), ``bccp_eval_decode`` decodes a
batched DPSUB chunk's (query, set, subset) lanes from its offset tables
(the batched DPSUB evaluate), ``btree_eval_decode`` decodes
an MPDP:Tree chunk's (query, set, edge) lanes from its offset tables (the
batched and the solo tree evaluate) and ``bgeneral_eval_decode`` an
MPDP-general chunk's (pair, rank) lanes from its pair table (the batched
and the solo general evaluate).  ``btree_eval_prune`` and
``bgeneral_eval_prune`` build the same lanes as the last two and run the
chunk bodies' epilogue in the kernel as well: the memo gathers, the join
cost, the per-segment minimum and the per-query counts, folded into the
caller's key and count buffers, or into a chunk's own buffer that
``unpack_pruned`` reads back (the evaluates of inner-join flights; typed
flights keep the two decode forms); ``commit_keys`` writes a level's
folded keys to the memo.  ``phase_a_blocks`` is no lane kernel: it finds
the blocks of a level's sets of one query (phase A of MPDP-general), one
row of block bitmaps a set.  Tensors on the CPU go to the plain
PyTorch version in ``ref``; tensors on a CUDA device go to the kernel, or
the wrapper raises (wrong dtype, shape, layout or mixed devices, or a
refused launch).  There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.

Kernels run on PyTorch's current stream of their tensors' device, the
stream the caching allocator orders frees on, so an input tensor the
caller drops right after the call is not reused before the kernel has
read it; that device is made current around the launch (``_run``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import build, ref

LAUNCHES = {"connectivity": 0, "connectivity_span": 0, "ccp_eval": 0,
            "ccp_eval_dpsub": 0, "grow_pair": 0, "bconnectivity": 0,
            "bconnectivity_span": 0, "bccp_eval": 0, "bccp_eval_decode": 0,
            "btree_eval": 0,
            "btree_eval_decode": 0, "bgeneral_eval": 0,
            "bgeneral_eval_decode": 0, "btree_eval_prune": 0,
            "bgeneral_eval_prune": 0, "phase_a_blocks": 0, "commit_keys": 0}
_SINGLE = ("connectivity", "ccp_eval", "grow_pair")   # one (nmax,) table
_SMEM_LIMIT = 48 * 1024       # static dynamic-shared-memory budget per block
_I32_MAX = (1 << 31) - 1
_I32_MIN = -(1 << 31)
CYC_CAP_HARD = 24             # phase_a_blocks' cycle slots (config.CYC_CAP_DEFAULT)


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
    if name in _SINGLE:
        _check_table(name, adj, nmax)
        dims = (L, nmax)
    else:
        dims = (L, _check_stack(name, adj, nmax, 0), nmax)
    outs = [torch.empty_like(lanes[0]) for _ in range(n_out)]
    if L == 0:
        return outs
    _run(name, lanes[0].device, *[t.data_ptr() for t in lanes],
         adj.data_ptr(), *[o.data_ptr() for o in outs], *dims)
    return outs


def _run(name: str, device, *args) -> None:
    """Call ``rt_<name>`` on ``device``'s current stream, with ``device``
    the current device for the launch (a shard on another card than the
    current one launches on its own card); raise if it was refused.  The
    outputs were allocated with ``device=`` named, which needs no current
    device."""
    lib = build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"rt_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{lib.rt_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def _check_table(name: str, adj, nmax: int) -> None:
    if adj.dtype != torch.int32 or adj.dim() != 1 or adj.shape[0] != nmax \
            or not adj.is_contiguous():
        raise ValueError(f"{name}: adj must be contiguous int32[{nmax}], "
                         f"got {adj.dtype}{tuple(adj.shape)}")
    if not 1 <= nmax <= 30:
        raise ValueError(f"{name}: unsupported table shape {tuple(adj.shape)}")


def _check_stack(name: str, adj_b, nmax: int, per_query: int,
                 fixed: int = 0) -> int:
    """Check the stacked (bcap, nmax) table and that it, ``per_query``
    more ints a query and ``fixed`` more fit the shared-memory budget;
    return bcap."""
    if adj_b.dtype != torch.int32 or adj_b.dim() != 2 \
            or adj_b.shape[-1] != nmax or not adj_b.is_contiguous():
        raise ValueError(f"{name}: adj_b must be contiguous int32[bcap, "
                         f"{nmax}], got {adj_b.dtype}{tuple(adj_b.shape)}")
    bcap = adj_b.shape[0]
    if not 1 <= nmax <= 30 or bcap < 1 \
            or 4 * (bcap * (nmax + per_query) + fixed) > _SMEM_LIMIT:
        raise ValueError(f"{name}: unsupported table shape {tuple(adj_b.shape)}")
    return bcap


def _check_vec(name: str, key: str, t, shape: tuple) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {key} must be contiguous int32{list(shape)}, "
                         f"got {t.dtype}{tuple(t.shape)}")


def _check_int32(name: str, **scalars) -> None:
    for key, v in scalars.items():
        if not 0 <= v <= _I32_MAX:
            raise ValueError(f"{name}: {key} = {v} is outside [0, 2^31)")


def _check_sets(name: str, all_sets) -> None:
    if all_sets.dtype != torch.int32 or all_sets.dim() != 1 \
            or not 1 <= all_sets.numel() <= _I32_MAX \
            or not all_sets.is_contiguous():
        raise ValueError(f"{name}: all_sets must be contiguous int32[N], "
                         f"0 < N < 2^31, got "
                         f"{all_sets.dtype}{tuple(all_sets.shape)}")


def _launch_span(k: int, rank0: int, count: int, binom, adj, nmax: int):
    """Check the arguments, allocate (S, conn) and launch
    ``rt_connectivity_span``."""
    name = "connectivity_span"
    _check_table(name, adj, nmax)
    if binom.dtype != torch.int32 or tuple(binom.shape) != (nmax + 1, nmax + 1) \
            or not binom.is_contiguous():
        raise ValueError(f"{name}: binom must be contiguous int32"
                         f"[{nmax + 1}, {nmax + 1}], got "
                         f"{binom.dtype}{tuple(binom.shape)}")
    if not 0 <= k <= nmax:
        raise ValueError(f"{name}: k = {k} is outside [0, {nmax}]")
    _check_int32(name, rank0=rank0, count=count, span_end=rank0 + count)
    S = torch.empty(count, dtype=torch.int32, device=adj.device)
    conn = torch.empty_like(S)
    if count:
        _run(name, adj.device, rank0, k, count, binom.data_ptr(),
             adj.data_ptr(), S.data_ptr(), conn.data_ptr(), nmax)
    return S, conn


def _launch_dpsub(all_sets, level_off: int, base_set: int, base_sub: int,
                  i: int, adj, nmax: int, chunk: int):
    """Check the arguments, allocate (lb, rb, ccp) and launch
    ``rt_ccp_eval_dpsub``."""
    name = "ccp_eval_dpsub"
    _check_table(name, adj, nmax)
    _check_sets(name, all_sets)
    if not 0 <= i <= 30:
        raise ValueError(f"{name}: i = {i} is outside [0, 30]")
    _check_int32(name, level_off=level_off, base_set=base_set,
                 base_sub=base_sub, chunk=chunk)
    outs = [torch.empty(chunk, dtype=torch.int32, device=adj.device)
            for _ in range(3)]
    if chunk:
        _run(name, adj.device, all_sets.data_ptr(), all_sets.numel(),
             level_off, base_set, base_sub, i, adj.data_ptr(),
             *[o.data_ptr() for o in outs], chunk, nmax)
    return tuple(outs)


def _launch_bspan(k: int, foff, count: int, binom, adj_b, nmax: int):
    """Check the arguments, allocate (S, conn, qid) and launch
    ``rt_bconnectivity_span``."""
    name = "bconnectivity_span"
    bcap = _check_stack(name, adj_b, nmax, 1, 1 + (nmax + 1) ** 2)
    _check_vec(name, "foff", foff, (bcap + 1,))
    _check_vec(name, "binom", binom, (nmax + 1, nmax + 1))
    if not 0 <= k <= nmax:
        raise ValueError(f"{name}: k = {k} is outside [0, {nmax}]")
    _check_int32(name, count=count)
    outs = [torch.empty(count, dtype=torch.int32, device=adj_b.device)
            for _ in range(3)]
    if count:
        _run(name, adj_b.device, k, foff.data_ptr(), count, binom.data_ptr(),
             adj_b.data_ptr(), *[o.data_ptr() for o in outs], bcap, nmax)
    return tuple(outs)


def _launch_dpsub_decode(all_sets, eoff, loff, soff, seg0: int, i: int,
                         adj_b, nmax: int, nseg: int, chunk: int):
    """Check the arguments, allocate (lb, rb, ccp, qid, seg) and launch
    ``rt_bccp_eval_decode``."""
    name = "bccp_eval_decode"
    bcap = _check_stack(name, adj_b, nmax, 3, 1)
    _check_sets(name, all_sets)
    _check_vec(name, "eoff", eoff, (bcap + 1,))
    for key, t in (("loff", loff), ("soff", soff)):
        _check_vec(name, key, t, (bcap,))
    if not 0 <= i <= 30:
        raise ValueError(f"{name}: i = {i} is outside [0, 30]")
    _check_int32(name, seg0=seg0, nseg=nseg, chunk=chunk)
    if nseg < 1:
        raise ValueError(f"{name}: nseg = {nseg} must be positive")
    outs = [torch.empty(chunk, dtype=torch.int32, device=adj_b.device)
            for _ in range(5)]
    if chunk:
        _run(name, adj_b.device, all_sets.data_ptr(), all_sets.numel(),
             eoff.data_ptr(), loff.data_ptr(), soff.data_ptr(), seg0, i,
             adj_b.data_ptr(), *[o.data_ptr() for o in outs], chunk, bcap,
             nmax, nseg)
    return tuple(outs)


def _check_tree(name: str, all_sets, eoff, loff, soff, seg0: int, m_b,
                emu_b, emv_b, adj_b, nmax: int, nseg: int, chunk: int):
    """Check the arguments of the MPDP:Tree forms; return (bcap, emax)."""
    bcap = _check_stack(name, adj_b, nmax, 4, 1)
    _check_sets(name, all_sets)
    _check_vec(name, "eoff", eoff, (bcap + 1,))
    for key, t in (("loff", loff), ("soff", soff), ("m_b", m_b)):
        _check_vec(name, key, t, (bcap,))
    emax = emu_b.shape[-1] if emu_b.dim() == 2 else 0
    if emax < 1:
        raise ValueError(f"{name}: emu_b must be int32[{bcap}, emax], emax > 0, "
                         f"got {emu_b.dtype}{tuple(emu_b.shape)}")
    _check_vec(name, "emu_b", emu_b, (bcap, emax))
    _check_vec(name, "emv_b", emv_b, (bcap, emax))
    _check_int32(name, seg0=seg0, nseg=nseg, chunk=chunk)
    if nseg < 1:
        raise ValueError(f"{name}: nseg = {nseg} must be positive")
    return bcap, emax


def _launch_tree_decode(all_sets, eoff, loff, soff, seg0: int, m_b, emu_b,
                        emv_b, adj_b, nmax: int, nseg: int, chunk: int):
    """Check the arguments, allocate (S, S_left, edge_in, qid, seg) and
    launch ``rt_btree_eval_decode``."""
    name = "btree_eval_decode"
    bcap, emax = _check_tree(name, all_sets, eoff, loff, soff, seg0, m_b,
                             emu_b, emv_b, adj_b, nmax, nseg, chunk)
    outs = [torch.empty(chunk, dtype=torch.int32, device=adj_b.device)
            for _ in range(5)]
    if chunk:
        _run(name, adj_b.device, all_sets.data_ptr(), all_sets.numel(),
             eoff.data_ptr(), loff.data_ptr(), soff.data_ptr(), seg0,
             m_b.data_ptr(), emu_b.data_ptr(), emv_b.data_ptr(), emax,
             adj_b.data_ptr(), *[o.data_ptr() for o in outs], chunk, bcap,
             nmax, nseg)
    return tuple(outs)


def _check_general(name: str, pairs, n_pairs: int, lane_count: int, adj_b,
                   nmax: int, chunk: int):
    """Check the arguments of the MPDP-general forms; return (bcap,
    pcap)."""
    bcap = _check_stack(name, adj_b, nmax, 0)
    if bcap > 1 and nmax > 16:
        raise ValueError(f"{name}: nmax = {nmax} with bcap = {bcap}: a stack "
                         f"of queries takes nmax <= 16")
    pcap = pairs.shape[-1] if pairs.dim() == 2 else 0
    if pcap < 1:
        raise ValueError(f"{name}: pairs must be int32[4, pcap], pcap > 0, "
                         f"got {pairs.dtype}{tuple(pairs.shape)}")
    _check_vec(name, "pairs", pairs, (4, pcap))
    _check_int32(name, pairs_numel=pairs.numel(), chunk=chunk)
    if not 1 <= n_pairs <= pcap:
        raise ValueError(f"{name}: n_pairs = {n_pairs} is outside [1, {pcap}]")
    if not 0 <= lane_count <= chunk:
        raise ValueError(f"{name}: lane_count = {lane_count} is outside "
                         f"[0, {chunk}]")
    return bcap, pcap


def _launch_general_decode(pairs, n_pairs: int, lane_count: int, adj_b,
                           nmax: int, chunk: int):
    """Check the arguments, allocate (S, S_left, enum_ok, ccp, qid, p) and
    launch ``rt_bgeneral_eval_decode``."""
    name = "bgeneral_eval_decode"
    bcap, pcap = _check_general(name, pairs, n_pairs, lane_count, adj_b, nmax,
                                chunk)
    outs = [torch.empty(chunk, dtype=torch.int32, device=adj_b.device)
            for _ in range(6)]
    if chunk:
        _run(name, adj_b.device, pairs.data_ptr(), pcap, n_pairs, lane_count,
             adj_b.data_ptr(), *[o.data_ptr() for o in outs], chunk, bcap,
             nmax)
    return tuple(outs)


def _check_memo(name: str, memo_cost, memo_rows) -> int:
    """Check the memo tables the fused forms gather from; return their
    size."""
    for key, t in (("memo_cost", memo_cost), ("memo_rows", memo_rows)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous() \
                or t.shape != memo_cost.shape \
                or not 1 <= t.numel() <= _I32_MAX:
            raise ValueError(f"{name}: {key} must be contiguous "
                             f"float32[size], 0 < size < 2^31, as long as "
                             f"memo_cost, got {t.dtype}{tuple(t.shape)}")
    return memo_cost.numel()


def _pruned_buffer(nseg: int, bcap: int, device) -> torch.Tensor:
    """A chunk's own output of the fused forms, zeroed: int64 keys[nseg],
    then int64 counts[2 * bcap]."""
    return torch.zeros(nseg + 2 * bcap, dtype=torch.int64, device=device)


def _check_int64(name: str, key: str, t, least: int, device) -> None:
    """Check a caller's int64 buffer: contiguous, one-dimensional, at
    least ``least`` entries, on ``device``."""
    if t.dtype != torch.int64 or t.dim() != 1 or t.numel() < least \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: {key} must be contiguous int64 with at "
                         f"least {least} entries on {device}, got "
                         f"{t.dtype}{tuple(t.shape)} on {t.device}")


def _check_targets(name: str, keys, counts, nseg: int, bcap: int,
                   device) -> None:
    """Check the caller's key and count buffers of a fused form: at least
    ``nseg`` keys and ``2 * bcap`` counts (``_check_int64``)."""
    _check_int64(name, "keys", keys, nseg, device)
    _check_int64(name, "counts", counts, 2 * bcap, device)


def _targets(name: str, keys, counts, nseg: int, bcap: int, device):
    """``(out, keys, counts)``: the caller's buffers, checked (``out`` its
    keys), or a chunk's own zeroed buffer and its two parts."""
    if keys is None:
        out = _pruned_buffer(nseg, bcap, device)
        return out, out[:nseg], out[nseg:]
    _check_targets(name, keys, counts, nseg, bcap, device)
    return keys, keys, counts


def _fold_cpu(name: str, buf, nseg: int, bcap: int, keys, counts):
    """The CPU path's output: ``ref.fold_into`` after the targets' check."""
    if keys is not None:
        _check_targets(name, keys, counts, nseg, bcap, buf.device)
    return ref.fold_into(buf, nseg, keys, counts)


def _launch_tree_prune(all_sets, eoff, loff, soff, seg0: int, m_b, emu_b,
                       emv_b, adj_b, memo_cost, memo_rows, nmax: int,
                       nseg: int, chunk: int, keys=None, counts=None):
    """Check the arguments and the targets (``_targets``) and launch
    ``rt_btree_eval_prune``."""
    name = "btree_eval_prune"
    bcap, emax = _check_tree(name, all_sets, eoff, loff, soff, seg0, m_b,
                             emu_b, emv_b, adj_b, nmax, nseg, chunk)
    size = _check_memo(name, memo_cost, memo_rows)
    out, keys, counts = _targets(name, keys, counts, nseg, bcap, adj_b.device)
    if chunk:
        _run(name, adj_b.device, all_sets.data_ptr(), all_sets.numel(),
             eoff.data_ptr(), loff.data_ptr(), soff.data_ptr(), seg0,
             m_b.data_ptr(), emu_b.data_ptr(), emv_b.data_ptr(), emax,
             adj_b.data_ptr(), memo_cost.data_ptr(), memo_rows.data_ptr(),
             size, keys.data_ptr(), counts.data_ptr(), chunk, bcap, nmax,
             nseg)
    return out


def _launch_general_prune(pairs, n_pairs: int, lane_count: int, adj_b,
                          memo_cost, memo_rows, nmax: int, chunk: int,
                          keys=None, counts=None):
    """Check the arguments and the targets (``_targets``) and launch
    ``rt_bgeneral_eval_prune``."""
    name = "bgeneral_eval_prune"
    bcap, pcap = _check_general(name, pairs, n_pairs, lane_count, adj_b, nmax,
                                chunk)
    size = _check_memo(name, memo_cost, memo_rows)
    out, keys, counts = _targets(name, keys, counts, pcap, bcap, adj_b.device)
    if chunk:
        _run(name, adj_b.device, pairs.data_ptr(), pcap, n_pairs, lane_count,
             adj_b.data_ptr(), memo_cost.data_ptr(), memo_rows.data_ptr(),
             size, keys.data_ptr(), counts.data_ptr(), chunk, bcap, nmax)
    return out


def _launch_commit(keys, idx, memo_cost, memo_left) -> None:
    """Check the arguments and launch ``rt_commit_keys``."""
    name = "commit_keys"
    n = idx.numel()
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous int32[n], got "
                         f"{idx.dtype}{tuple(idx.shape)}")
    _check_int64(name, "keys", keys, n, idx.device)
    for key, t, dtype in (("memo_cost", memo_cost, torch.float32),
                          ("memo_left", memo_left, torch.int32)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() \
                or t.shape != memo_cost.shape \
                or not 1 <= t.numel() <= _I32_MAX:
            raise ValueError(f"{name}: {key} must be contiguous {dtype}"
                             f"[size], 0 < size < 2^31, as long as "
                             f"memo_cost, got {t.dtype}{tuple(t.shape)}")
    if n:
        _run(name, idx.device, keys.data_ptr(), idx.data_ptr(), n,
             memo_cost.data_ptr(), memo_left.data_ptr(), memo_cost.numel())


def _launch_phase_a(S, adj, eu_idx, ev_idx, edge_live, nmax: int,
                    eff_cap: int, width: int):
    """Check the arguments, allocate the int32[N, width] rows and launch
    ``rt_phase_a_blocks``."""
    name = "phase_a_blocks"
    _check_table(name, adj, nmax)
    if S.dtype != torch.int32 or S.dim() != 1 or not S.is_contiguous():
        raise ValueError(f"{name}: S must be contiguous int32[N], got "
                         f"{S.dtype}{tuple(S.shape)}")
    emax = eu_idx.shape[0] if eu_idx.dim() == 1 else 0
    if emax < 1:
        raise ValueError(f"{name}: eu_idx must be int32[emax], emax > 0, got "
                         f"{eu_idx.dtype}{tuple(eu_idx.shape)}")
    _check_vec(name, "eu_idx", eu_idx, (emax,))
    _check_vec(name, "ev_idx", ev_idx, (emax,))
    if edge_live.dtype != torch.bool or tuple(edge_live.shape) != (emax,) \
            or not edge_live.is_contiguous():
        raise ValueError(f"{name}: edge_live must be contiguous bool[{emax}], "
                         f"got {edge_live.dtype}{tuple(edge_live.shape)}")
    if 4 * (nmax + 2 * emax) > _SMEM_LIMIT:
        raise ValueError(f"{name}: unsupported edge arrays of {emax}")
    if not 1 <= eff_cap <= CYC_CAP_HARD:
        raise ValueError(f"{name}: eff_cap = {eff_cap} is outside "
                         f"[1, {CYC_CAP_HARD}]")
    if not 1 <= width <= eff_cap + nmax:
        raise ValueError(f"{name}: width = {width} is outside "
                         f"[1, {eff_cap + nmax}]")
    _check_int32(name, slots=S.numel() * width)
    out = torch.empty((S.numel(), width), dtype=torch.int32, device=S.device)
    if S.numel():
        _run(name, S.device, S.data_ptr(), adj.data_ptr(), eu_idx.data_ptr(),
             ev_idx.data_ptr(), edge_live.data_ptr(), out.data_ptr(),
             S.numel(), nmax, emax, eff_cap, width)
    return out


# -- solo engine ---------------------------------------------------------------

def connectivity(S, adj, nmax: int):
    """int32 1 where G[S] is connected."""
    if _on_cpu("connectivity", (S,), adj):
        return ref.connectivity_ref(S, adj, nmax)
    return _launch("connectivity", (S,), adj, nmax, 1)[0]


def connectivity_span(k: int, rank0: int, count: int, binom, adj, nmax: int):
    """The filter of one level span: colex ranks ``rank0 .. rank0 + count
    - 1`` of the k-subsets (``binom`` the int32 (nmax+1)^2 table of
    ``unrank.binom_table``) -> (S, conn int32[count]), conn 1 where G[S]
    is connected."""
    if _on_cpu("connectivity_span", (binom,), adj):
        return ref.connectivity_span_ref(k, rank0, count, binom, adj, nmax)
    return _launch_span(k, rank0, count, binom, adj, nmax)


def ccp_eval(S, sub, adj, nmax: int):
    """DPSUB lanes -> (lb, rb, ccp int32)."""
    if _on_cpu("ccp_eval", (S, sub), adj):
        return ref.ccp_eval_ref(S, sub, adj, nmax)
    return tuple(_launch("ccp_eval", (S, sub), adj, nmax, 3))


def ccp_eval_dpsub(all_sets, level_off: int, base_set: int, base_sub: int,
                   i: int, adj, nmax: int, chunk: int):
    """The ``chunk`` lanes of a level-i DPSUB chunk -> (lb, rb, ccp int32):
    lane t is subset rank ``(base_sub + t) & (2^i - 1)`` of set
    ``all_sets[level_off + base_set + ((base_sub + t) >> i)]`` (index
    clamped).  Lanes past the chunk's live count are computed all the same;
    the caller masks them."""
    if _on_cpu("ccp_eval_dpsub", (all_sets,), adj):
        return ref.ccp_eval_dpsub_ref(all_sets, level_off, base_set,
                                      base_sub, i, adj, nmax, chunk)
    return _launch_dpsub(all_sets, level_off, base_set, base_sub, i, adj,
                         nmax, chunk)


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


def bconnectivity_span(k: int, foff, count: int, binom, adj_b, nmax: int):
    """The batched filter of one level span: lane t < count belongs to
    query ``q = searchsorted(foff, t, side="right") - 1`` (``foff`` the
    int32[bcap+1] prefix of C(n_q, k), padded with its last value) and
    unranks colex rank ``t - foff[q]`` of the k-subsets (``binom`` as for
    ``connectivity_span``) -> (S, conn, qid int32[count]), conn 1 where
    ``t < foff[bcap]`` and G_q[S] is connected."""
    if _on_cpu("bconnectivity_span", (foff, binom), adj_b):
        return ref.bconnectivity_span_ref(k, foff, count, binom, adj_b, nmax)
    return _launch_bspan(k, foff, count, binom, adj_b, nmax)


def bccp_eval(S, sub, qid, adj_b, nmax: int):
    """Batched DPSUB lanes -> (lb, rb, ccp int32)."""
    if _on_cpu("bccp_eval", (S, sub, qid), adj_b):
        return ref.bccp_eval_ref(S, sub, qid, adj_b, nmax)
    return tuple(_launch("bccp_eval", (S, sub, qid), adj_b, nmax, 3))


def bccp_eval_decode(all_sets, eoff, loff, soff, seg0: int, i: int, adj_b,
                     nmax: int, nseg: int, chunk: int):
    """The ``chunk`` lanes of a batched level-i DPSUB chunk -> (lb, rb, ccp,
    qid, seg int32[chunk]).  ``eoff`` int32[bcap+1] holds the chunk-local
    lane offsets of the queries (prefix of sets x 2^i), ``loff``/``soff``
    int32[bcap] each query's base in ``all_sets`` and in the level's
    segments (as for ``btree_eval_decode``).  Lane t is subset rank ``local
    & (2^i - 1)`` of set ``local >> i`` of its query ``q =
    searchsorted(eoff, t, side="right") - 1`` (``local = t - eoff[q]``, set
    index clamped into ``all_sets``); ccp is 1 where ``t < eoff[bcap]`` and
    (lb, rb) is a csg-cmp pair of G_q, seg is ``soff[q] + set - seg0``
    clamped to ``[0, nseg)``.  Dead lanes are decoded all the same."""
    if _on_cpu("bccp_eval_decode", (all_sets, eoff, loff, soff), adj_b):
        return ref.bccp_eval_decode_ref(all_sets, eoff, loff, soff, seg0, i,
                                        adj_b, nmax, nseg, chunk)
    return _launch_dpsub_decode(all_sets, eoff, loff, soff, seg0, i, adj_b,
                                nmax, nseg, chunk)


def btree_eval(S, ub, vb, qid, adj_b, nmax: int):
    """Batched MPDP:Tree lanes -> (S_left, edge_in int32)."""
    if _on_cpu("btree_eval", (S, ub, vb, qid), adj_b):
        return ref.btree_eval_ref(S, ub, vb, qid, adj_b, nmax)
    return tuple(_launch("btree_eval", (S, ub, vb, qid), adj_b, nmax, 2))


def btree_eval_decode(all_sets, eoff, loff, soff, seg0: int, m_b, emu_b,
                      emv_b, adj_b, nmax: int, nseg: int, chunk: int):
    """The ``chunk`` lanes of an MPDP:Tree chunk -> (S, S_left, edge_in,
    qid, seg int32[chunk]).  ``eoff`` int32[bcap+1] holds the chunk-local
    lane offsets of the queries (prefix of sets x edges), ``loff``/``soff``
    int32[bcap] each query's base in ``all_sets`` and in the level's
    segments, ``m_b`` its edge count and ``emu_b``/``emv_b`` int32[bcap,
    emax] its edge endpoint bitmaps.  Lane t is edge ``local % m_q`` of set
    ``local // m_q`` of its query (``local = t - eoff[q]``, set index
    clamped into ``all_sets``); edge_in is 1 where ``t < eoff[bcap]`` and
    both endpoints lie in S, seg is ``soff[q] + set - seg0`` clamped to
    ``[0, nseg)``.  Dead lanes are decoded all the same."""
    if _on_cpu("btree_eval_decode",
               (all_sets, eoff, loff, soff, m_b, emu_b, emv_b), adj_b):
        return ref.btree_eval_decode_ref(all_sets, eoff, loff, soff, seg0,
                                         m_b, emu_b, emv_b, adj_b, nmax,
                                         nseg, chunk)
    return _launch_tree_decode(all_sets, eoff, loff, soff, seg0, m_b, emu_b,
                               emv_b, adj_b, nmax, nseg, chunk)


def bgeneral_eval(S, block, r, qid, adj_b, nmax: int):
    """Batched MPDP-general lanes -> (lb, S_left, ccp int32)."""
    if _on_cpu("bgeneral_eval", (S, block, r, qid), adj_b):
        return ref.bgeneral_eval_ref(S, block, r, qid, adj_b, nmax)
    return tuple(_launch("bgeneral_eval", (S, block, r, qid), adj_b, nmax, 3))


def bgeneral_eval_decode(pairs, n_pairs: int, lane_count: int, adj_b,
                         nmax: int, chunk: int):
    """The ``chunk`` lanes of an MPDP-general chunk -> (S, S_left, enum_ok,
    ccp, qid, p int32[chunk]).  ``pairs`` int32[4, pcap] stacks the
    chunk's (set, block, query, chunk-local lane offset) rows, the offset
    row non-decreasing (padding ``chunks._CLIP``); the first ``n_pairs``
    are real.  Lane t is rank ``t - off[p]`` of the block of pair ``p =
    searchsorted(off, t, side="right") - 1`` (clamped to ``[0,
    n_pairs)``), on the adjacency row of its query (clamped to ``[0,
    bcap)``; ``adj_b`` one row for the solo engine).  enum_ok is 1 where
    ``t < lane_count`` and both block sides are non-empty, ccp where also
    (lb, rb) is a csg-cmp pair; ``S_left = grow(lb)`` inside ``S & ~rb``.
    Dead lanes are decoded all the same."""
    if _on_cpu("bgeneral_eval_decode", (pairs,), adj_b):
        return ref.bgeneral_eval_decode_ref(pairs, n_pairs, lane_count, adj_b,
                                            nmax, chunk)
    return _launch_general_decode(pairs, n_pairs, lane_count, adj_b, nmax,
                                  chunk)


# -- the fused evaluate epilogue -------------------------------------------

def btree_eval_prune(all_sets, eoff, loff, soff, seg0: int, m_b, emu_b,
                     emv_b, adj_b, memo_cost, memo_rows, nmax: int, nseg: int,
                     chunk: int, keys=None, counts=None):
    """The ``chunk`` lanes of ``btree_eval_decode``, costed and pruned: per
    segment the cheapest split (ties to the larger left bitmap, a lane of
    ``INF`` cost offering left 0, an empty segment ``INF`` and
    ``INT32_MIN``) as one int64 key, per query its edge_in lanes, twice
    (every in-set edge is a ccp pair).  A lane's split costs ``(cl + cr) +
    cost.join_cost(rl, rr, rows_S)`` on ``memo_cost``/``memo_rows``
    (float32[size]) at ``(q << nmax) | x``, clamped into them; ``INF``
    where edge_in is 0.

    The keys and counts fold into the caller's ``keys`` (int64, at least
    ``nseg``: the maximum with what is there) and ``counts`` (int64[2 *
    bcap]: added), and ``keys`` comes back; without them, into a chunk's
    own zeroed int64[nseg + 2 * bcap] buffer, which comes back for
    ``unpack_pruned``.  On the CPU: the decode form, then the chunk bodies'
    torch epilogue (``ref.tree_epilogue``), folded by ``ref.fold_into``."""
    if _on_cpu("btree_eval_prune", (all_sets, eoff, loff, soff, m_b, emu_b,
                                    emv_b, memo_cost, memo_rows), adj_b):
        return _fold_cpu("btree_eval_prune", ref.tree_epilogue(
            btree_eval_decode(all_sets, eoff, loff, soff, seg0, m_b, emu_b,
                              emv_b, adj_b, nmax, nseg, chunk),
            adj_b, memo_cost, memo_rows, nmax, nseg), nseg, adj_b.shape[0],
            keys, counts)
    return _launch_tree_prune(all_sets, eoff, loff, soff, seg0, m_b, emu_b,
                              emv_b, adj_b, memo_cost, memo_rows, nmax, nseg,
                              chunk, keys, counts)


def bgeneral_eval_prune(pairs, n_pairs: int, lane_count: int, adj_b,
                        memo_cost, memo_rows, nmax: int, chunk: int,
                        keys=None, counts=None):
    """The ``chunk`` lanes of ``bgeneral_eval_decode``, costed and pruned:
    one key a pair of the table (``pcap`` of them), as for
    ``btree_eval_prune``, and per query its enum_ok and its ccp lanes; a
    lane's split is ``INF`` where ccp is 0.  Targets and the CPU path as
    ``btree_eval_prune``'s (``ref.general_epilogue``)."""
    if _on_cpu("bgeneral_eval_prune", (pairs, memo_cost, memo_rows), adj_b):
        return _fold_cpu("bgeneral_eval_prune", ref.general_epilogue(
            bgeneral_eval_decode(pairs, n_pairs, lane_count, adj_b, nmax,
                                 chunk),
            pairs.shape[1], adj_b, memo_cost, memo_rows, nmax),
            pairs.shape[1], adj_b.shape[0], keys, counts)
    return _launch_general_prune(pairs, n_pairs, lane_count, adj_b, memo_cost,
                                 memo_rows, nmax, chunk, keys, counts)


def commit_keys(keys, idx, memo_cost, memo_left) -> None:
    """Commit a level's folded keys to the memo: key t (int64) belongs to
    memo entry ``idx[t]`` (int32[n]; the keys of one entry consecutive), and
    each entry whose largest key holds a finite cost gets that cost in
    ``memo_cost`` and its left bitmap in ``memo_left``, in place; an index
    outside the memo is dropped.  On the CPU: ``ref.commit_keys_ref``."""
    if _on_cpu("commit_keys", (keys, memo_cost, memo_left), idx):
        ref.commit_keys_ref(keys, idx, memo_cost, memo_left)
        return
    _launch_commit(keys, idx, memo_cost, memo_left)


def unpack_pruned(buf: np.ndarray, bcap: int):
    """A fused form's own buffer, fetched to the host (int64[nseg + 2 *
    bcap]) -> (seg_cost float32[nseg], seg_left int32[nseg], enumerated
    int64[bcap], ccp int64[bcap]).  Key k holds ``0x7F800000 - bits(cost)``
    in its high word and ``left ^ INT32_MIN`` in its low one
    (little-endian: the low word first); the key 0 of an empty segment
    reads ``INF`` and ``INT32_MIN``."""
    n = len(buf) - 2 * bcap
    w = buf[:n].view(np.int32)
    seg_cost = (np.int32(0x7F800000) - w[1::2]).view(np.float32)
    seg_left = w[0::2] ^ np.int32(_I32_MIN)
    return seg_cost, seg_left, buf[n: n + bcap], buf[n + bcap:]


# -- phase A of MPDP-general ---------------------------------------------------

def phase_a_blocks(S, adj, eu_idx, ev_idx, edge_live, nmax: int,
                   eff_cap: int, width: int):
    """The blocks of G[S] for each set of ``S`` (int32[N]) of one query ->
    int32[N, width]: row t holds set t's merged cycle blocks in slot order,
    then its bridges by ascending child vertex, as vertex bitmaps,
    left-justified and zero after (the first ``width`` of them; at most
    ``eff_cap + popcount(S) - 1`` are non-zero).  ``adj`` is the query's
    int32[nmax] table, ``eu_idx``/``ev_idx`` its int32[emax] edge endpoints
    (-1 pad), ``edge_live`` bool[emax]; ``eff_cap`` fundamental-cycle slots
    (at most ``CYC_CAP_HARD`` on a card) keep the first non-tree edges of
    G[S] in edge order."""
    if _on_cpu("phase_a_blocks", (S, eu_idx, ev_idx, edge_live), adj):
        return ref.phase_a_blocks_ref(S, adj, eu_idx, ev_idx, edge_live,
                                      nmax, eff_cap, width)
    return _launch_phase_a(S, adj, eu_idx, ev_idx, edge_live, nmax, eff_cap,
                           width)
