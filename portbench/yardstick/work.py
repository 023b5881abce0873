"""Bytes and int32 operations that one launch of a lane-building kernel
needs, from its arguments and outputs, and the launch's roofline bound.

Frozen from the port's ``chip_smoke.py`` (``op_count``, ``span_work``,
``dpsub_work``, ``bspan_work``, ``tree_decode_work``,
``dpsub_decode_work``, ``general_decode_work``): a fixed per-lane cost plus
``OPS_PER_STEP`` for each set bit a walk visits, the unrank steps, the
binary searches and the decodes, counted on what these inputs need; bytes
count each input read once and each output written once.  The outputs a
count reads (the lanes' sets and query ids) are the launch's own, as the
kernel returned them.  The bitset helpers are copied too, so nothing here
imports the program.
"""
from __future__ import annotations

import torch

from .peaks import HBM_BYTES_S, INT32_OPS_S

OPS_PER_STEP = 3            # one set-bit step: ffs, row load, OR
OPS_PER_LANE = 12           # per-lane decode, loads, stores
UNRANK_OPS_PER_STEP = 4     # load C(v,kk), compare, subtract/OR, decrement
DPSUB_DECODE_OPS = 6        # add, shift, add, and, add, clamp
BDPSUB_DECODE_OPS = 10      # subtract, shift, mask, add, clamps, seg add,
                            # subtract and clamp
SEARCH_OPS = 4              # one binary-search step: load, compare,
                            # select, halve
TREE_DECODE_OPS = 30        # subtract, max, int32 division (about 20
                            # instructions), floor fix-up, clamps, adds,
                            # two edge loads, the seg clamp

# the port's wrapper name -> (its CUDA kernel's name in a device trace,
# the argument names of the wrapper in order)
KERNELS = {
    "connectivity_span": ("connectivity_kernel<true>",
                          ("k", "rank0", "count", "binom", "adj", "nmax")),
    "ccp_eval_dpsub": ("ccp_eval_dpsub_kernel",
                       ("all_sets", "level_off", "base_set", "base_sub", "i",
                        "adj", "nmax", "chunk")),
    "bconnectivity_span": ("bconnectivity_span_kernel",
                           ("k", "foff", "count", "binom", "adj_b", "nmax")),
    "bccp_eval_decode": ("bccp_eval_decode_kernel",
                         ("all_sets", "eoff", "loff", "soff", "seg0", "i",
                          "adj_b", "nmax", "nseg", "chunk")),
    "btree_eval_decode": ("btree_eval_decode_kernel",
                          ("all_sets", "eoff", "loff", "soff", "seg0", "m_b",
                           "emu_b", "emv_b", "adj_b", "nmax", "nseg",
                           "chunk")),
    "bgeneral_eval_decode": ("bgeneral_eval_decode_kernel",
                             ("pairs", "n_pairs", "lane_count", "adj_b",
                              "nmax", "chunk")),
}


# ------------------------------------------------------------ bit helpers --

def popcount(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def lsb(x):
    return x & (~x + 1)


def _or_last(x):
    while x.shape[-1] > 1:
        if x.shape[-1] & 1:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] | x[..., 1::2]
    return x[..., 0]


def _shifts(nmax, like):
    return torch.arange(nmax, dtype=torch.int32, device=like.device)


def neighbors_rows(s, adjq):
    mem = ((s[..., None] >> _shifts(adjq.shape[-1], s)) & 1).bool()
    return _or_last(torch.where(mem, adjq, 0))


def grow_rows(src, restrict, adjq):
    cur = src & restrict
    while True:
        nxt = (cur | neighbors_rows(cur, adjq)) & restrict
        if torch.equal(nxt, cur):
            return cur
        cur = nxt


def pdep(rank, mask, nmax):
    sh = _shifts(nmax, mask)
    below = (torch.ones_like(sh) << sh) - 1
    k = popcount(mask[..., None] & below)
    mask_bit = (mask[..., None] >> sh) & 1
    take = (rank[..., None] >> k) & 1
    return _or_last((mask_bit & take) << sh)


# ---------------------------------------------------------- walks' steps --

def op_count(name, lanes, adj, nmax) -> int:
    """int32 operations of the walks: a fixed per-lane cost plus
    OPS_PER_STEP per set bit visited (pdep over the mask, neighbours over
    the source, one expansion per reached vertex)."""
    adjq = adj if adj.dim() == 1 else adj[
        lanes["qid"].clamp(0, adj.shape[0] - 1)]
    pc = popcount
    S = lanes["S"]
    nm = (1 << nmax) - 1

    def reach(src, restrict, rows):
        return pc(grow_rows(src, restrict, rows) & nm)

    def ccp_steps(lb, rb):
        live = (lb != 0) & (rb != 0)
        cross = live & ((neighbors_rows(lb, adjq) & rb) != 0)
        return (pc(lb & nm) * live + cross * (reach(lsb(lb), lb, adjq)
                                              + reach(lsb(rb), rb, adjq)))

    if name == "connectivity":
        steps = reach(lsb(S), S, adjq)
    elif name == "ccp_eval":
        lb = pdep(lanes["sub"], S, nmax)
        steps = pc(S & nm) + ccp_steps(lb, S & ~lb)
    elif name == "bgeneral_eval_decode":            # ccp only on live lanes
        blk = lanes["block"]
        lb = pdep(lanes["r"], blk, nmax)
        rb = blk & ~lb
        steps = (pc(blk & nm) + lanes["live"] * ccp_steps(lb, rb)
                 + reach(lb, S & ~rb, adjq))
    elif name == "btree_eval":
        ub, vb = lanes["ub"], lanes["vb"]
        sh = _shifts(nmax, S)
        excl = (torch.where(((ub[:, None] >> sh) & 1) == 1, vb[:, None], 0)
                | torch.where(((vb[:, None] >> sh) & 1) == 1, ub[:, None], 0))
        steps = reach(ub, S, adjq & ~excl)
    else:
        raise ValueError(f"no walk count for {name!r}")
    return int(steps.to(torch.int64).sum()) * OPS_PER_STEP \
        + OPS_PER_LANE * S.numel()


def search_steps(bcap: int) -> int:
    """Iterations of the binary search over bcap + 1 offsets."""
    return (bcap + 1).bit_length()


# ------------------------------------------------ one launch's (bytes, ops) --

def span_work(a, out):
    """connectivity_span: S and conn written, the tables read; per lane
    the unrank steps (v = nmax - 1 down to S's lowest bit) and the walk."""
    S = out[0]
    nmax = a["nmax"]
    tz = popcount(lsb(S) - 1)
    steps = torch.where(S != 0, nmax - tz, 0)
    nbytes = 8 * a["count"] + 4 * (a["binom"].numel() + a["adj"].numel())
    return nbytes, (int(steps.to(torch.int64).sum()) * UNRANK_OPS_PER_STEP
                    + op_count("connectivity", {"S": S}, a["adj"], nmax))


def dpsub_work(a, out):
    """ccp_eval_dpsub: lb, rb and ccp written, each distinct set entry and
    the table read; per lane the decode and the ccp_eval walks."""
    chunk, i = a["chunk"], a["i"]
    all_sets = a["all_sets"]
    t = torch.arange(chunk, dtype=torch.int32, device=all_sets.device)
    sub_g = a["base_sub"] + t
    idx = (a["level_off"] + a["base_set"] + (sub_g >> i)).clamp(
        0, all_sets.numel() - 1)
    lanes = {"S": all_sets[idx], "sub": sub_g & ((1 << i) - 1)}
    nbytes = 12 * chunk + 4 * (torch.unique(idx).numel() + a["adj"].numel())
    return nbytes, (op_count("ccp_eval", lanes, a["adj"], a["nmax"])
                    + DPSUB_DECODE_OPS * chunk)


def bspan_work(a, out):
    """bconnectivity_span: S, conn and qid written, the tables read; per
    lane the binary search and the unrank steps, and on live lanes the
    connectivity walk."""
    S, _, qid = out
    foff, count, adj_b, nmax = a["foff"], a["count"], a["adj_b"], a["nmax"]
    live = torch.arange(count, device=S.device) < foff[-1]
    tz = popcount(lsb(S) - 1)
    steps = torch.where(S != 0, nmax - tz, 0)
    nbytes = 12 * count + 4 * (foff.numel() + a["binom"].numel()
                               + adj_b.numel())
    walk = op_count("connectivity", {"S": S[live], "qid": qid[live]}, adj_b,
                    nmax)
    return nbytes, (int(steps.to(torch.int64).sum()) * UNRANK_OPS_PER_STEP
                    + SEARCH_OPS * search_steps(adj_b.shape[0]) * count
                    + OPS_PER_LANE * int((~live).sum()) + walk)


def tree_decode_work(a, out):
    """btree_eval_decode: five lane outputs written, each distinct
    ``all_sets`` entry and the tables read; per lane the binary search,
    the decode and the btree_eval walk."""
    S, _, _, qid, _ = out
    all_sets, eoff, loff = a["all_sets"], a["eoff"], a["loff"]
    m_b, emu_b, emv_b, adj_b = a["m_b"], a["emu_b"], a["emv_b"], a["adj_b"]
    chunk = a["chunk"]
    t = torch.arange(chunk, dtype=torch.int32, device=S.device)
    local = t - eoff[qid]
    mq = m_b[qid].clamp(min=1)
    e = torch.remainder(local, mq).clamp(0, emu_b.shape[1] - 1)
    idx = (loff[qid] + torch.div(local, mq, rounding_mode="floor")).clamp(
        0, all_sets.numel() - 1)
    lanes = {"S": S, "ub": emu_b[qid, e], "vb": emv_b[qid, e], "qid": qid}
    tables = sum(x.numel() for x in (eoff, loff, a["soff"], m_b, emu_b,
                                     emv_b, adj_b))
    nbytes = 20 * chunk + 4 * (torch.unique(idx).numel() + tables)
    return nbytes, (op_count("btree_eval", lanes, adj_b, a["nmax"])
                    + (TREE_DECODE_OPS + SEARCH_OPS * search_steps(
                        adj_b.shape[0])) * chunk)


def dpsub_decode_work(a, out):
    """bccp_eval_decode: five lane outputs written, each distinct
    ``all_sets`` entry and the tables read; per lane the binary search,
    the decode and the pdep walk, and on live lanes the ccp test."""
    lb, rb, _, qid, _ = out
    all_sets, eoff, loff, i = a["all_sets"], a["eoff"], a["loff"], a["i"]
    adj_b, nmax, chunk = a["adj_b"], a["nmax"], a["chunk"]
    t = torch.arange(chunk, dtype=torch.int32, device=lb.device)
    live = t < eoff[-1]
    local = t - eoff[qid]
    idx = (loff[qid] + (local >> i)).clamp(0, all_sets.numel() - 1)
    S = lb | rb
    lanes = {"S": S[live], "sub": (local & ((1 << i) - 1))[live],
             "qid": qid[live]}
    tables = sum(x.numel() for x in (eoff, loff, a["soff"], adj_b))
    nbytes = 20 * chunk + 4 * (torch.unique(idx).numel() + tables)
    dead = int((~live).sum())
    pdep_dead = int(popcount(S[~live] & ((1 << nmax) - 1)).to(
        torch.int64).sum())
    return nbytes, (op_count("ccp_eval", lanes, adj_b, nmax)
                    + OPS_PER_STEP * pdep_dead + OPS_PER_LANE * dead
                    + (BDPSUB_DECODE_OPS + SEARCH_OPS * search_steps(
                        adj_b.shape[0])) * chunk)


def general_decode_work(a, out):
    """bgeneral_eval_decode: six lane outputs written, the pair table and
    the adjacency stack read; per lane the binary search over the pair
    offsets, the decode and the walks (pdep over the block, the ccp test
    on live lanes, the grow)."""
    S, _, _, _, qid, p = out
    pairs, adj_b, chunk = a["pairs"], a["adj_b"], a["chunk"]
    t = torch.arange(chunk, dtype=torch.int32, device=S.device)
    lanes = {"S": S, "qid": qid, "block": pairs[1][p], "r": t - pairs[3][p],
             "live": (t < a["lane_count"]).to(torch.int32)}
    nbytes = 24 * chunk + 4 * (pairs.numel() + adj_b.numel())
    return nbytes, (op_count("bgeneral_eval_decode", lanes, adj_b, a["nmax"])
                    + SEARCH_OPS * search_steps(pairs.shape[1] - 1) * chunk)


WORK = {"connectivity_span": span_work, "ccp_eval_dpsub": dpsub_work,
        "bconnectivity_span": bspan_work, "bccp_eval_decode": dpsub_decode_work,
        "btree_eval_decode": tree_decode_work,
        "bgeneral_eval_decode": general_decode_work}


def bound_s(name: str, args: dict, out) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the launch's roofline bound, the
    larger of its bytes over HBM bandwidth and its int32 operations over
    the assumed int32 peak."""
    nbytes, ops = WORK[name](args, out)
    t_b, t_o = nbytes / HBM_BYTES_S, ops / INT32_OPS_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
