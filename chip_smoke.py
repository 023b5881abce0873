#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Usage:  python3 chip_smoke.py        (one CUDA card; exits non-zero on any
                                      failure, and without a card)

Phases, in order, none of them caught:
  1. device  — card name/count and ``nvidia-smi`` name + power limit;
  2. build   — compile ``kernels/csrc/ccp_eval.cu`` with nvcc for sm_90a;
  3. kernels — each of the nine CUDA entry points against its plain
     PyTorch version on the same card tensors, bit for bit, lanes built
     with numpy from a seed over real generator graphs: the four batched
     kernels at L = 32768 and the ragged L in {1, 129, 32767}, nmax in
     {8, 16}, bcap in {4, 32}; the three solo-engine kernels, and
     ``btree_eval`` on the one-row table the solo tree evaluate gives it,
     at the same L and nmax in {8, 16, 24, 30}; the two solo forms that
     build their own lanes (``connectivity_span`` over a rank span,
     ``ccp_eval_dpsub`` over a DPSUB chunk with dead and clamped lanes) at
     count or chunk in {1, 129, 32767, 32768} and nmax in {8, 16, 24, 30},
     and ``connectivity_span`` at d4's largest span (chain(25), level 12,
     5,200,300 ranks at nmax 30).  Times by CUDA events (kernel and plain
     version) and the bound of each, at L = 32768 with nmax = 16, bcap = 32
     (batched) or nmax = 24 (solo); ``ccp_eval_dpsub`` on d3's real level
     sets, ``connectivity_span`` at L = 32768 (printed) and at d4's span
     (the JSON line);
  4. batched path — ``optimize_many`` on ``cuda`` over three streams, every
     plan validated and every cost held against the host DPccp oracle
     (relative 1e-4), ``Counters`` and costs of stream (c) and the first
     four queries of (a) and (b) against the port's own ``device="cpu"``
     run (exact / relative 1e-5), launch counters read around exactly
     this path; then a ``torch.profiler`` window over stream (a);
  5. solo path — ``engine.optimize`` on ``cuda`` over parts d1-d5 (MPDP-
     general at nmax 24, MPDP:Tree at nmax 24, DPSUB, the nmax-30 bucket,
     then dpsize, dpccp, frontier expansion and ``optimize_many``'s solo
     route), each plan validated and each cost held against DPccp
     (relative 1e-4), d1, d3 and d5 against the ``device="cpu"`` run
     (``Counters`` exact, costs relative 1e-5), one ``connectivity_span``
     launch per level span, launch counters read around exactly this
     path; then a ``torch.profiler`` window over d1.
The last three lines of standard output are a JSON object with one entry
per kernel, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import json
import os
import re
import subprocess
import sys
import time
from math import comb

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core import batch, dpccp, engine  # noqa: E402
from repro_torch.core import bitset as bs  # noqa: E402
from repro_torch.core import unrank as ur  # noqa: E402
from repro_torch.core.plan import validate_plan  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.workloads import generators as gen  # noqa: E402

HBM_BYTES_S = 3.35e12                 # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_S = 132 * 64 * 1.98e9       # 132 SMs x 64 INT32 lanes x 1.98 GHz
OPS_PER_STEP = 3                      # one set-bit step: ffs, row load, OR
OPS_PER_LANE = 12                     # per-lane decode, loads, stores
UNRANK_OPS_PER_STEP = 4               # one unrank step: load C(v,kk), compare,
                                      # subtract/OR, decrement
DPSUB_DECODE_OPS = 6                  # add, shift, add, and, add, clamp
L_MAIN = 32768                        # CHUNK: lanes per call on the main path
DEV = torch.device("cuda")

KERNELS = {
    # name: (inputs, outputs, line of the Pallas kernel it replaces); the
    # two forms that build their own lanes take no lane inputs
    "connectivity": (("S",), 1, "src/repro/kernels/ccp_eval.py:81"),
    "connectivity_span": ((), 2, "src/repro/kernels/ccp_eval.py:81 + the "
                          "unrank of src/repro/core/engine.py:72-85"),
    "ccp_eval": (("S", "sub"), 3, "src/repro/kernels/ccp_eval.py:65"),
    "ccp_eval_dpsub": ((), 3, "src/repro/kernels/ccp_eval.py:65 + the DPSUB "
                       "decode of src/repro/core/engine.py:179-188"),
    "grow_pair": (("S", "lb", "rb"), 2, "src/repro/kernels/ccp_eval.py:88"),
    "bconnectivity": (("S", "qid"), 1, "src/repro/kernels/ccp_eval.py:133"),
    "bccp_eval": (("S", "sub", "qid"), 3, "src/repro/kernels/ccp_eval.py:142"),
    "btree_eval": (("S", "ub", "vb", "qid"), 2,
                   "src/repro/kernels/ccp_eval.py:159"),
    "bgeneral_eval": (("S", "block", "r", "qid"), 3,
                      "src/repro/kernels/ccp_eval.py:184"),
}
SOLO = ("connectivity", "ccp_eval", "grow_pair")
SPAN_FORMS = ("connectivity_span", "ccp_eval_dpsub")
BATCHED = ("bconnectivity", "bccp_eval", "btree_eval", "bgeneral_eval")
SOLO_CHECKED = SOLO + ("btree_eval",)   # btree_eval on a one-row table
# what the solo path runs: the set-given connectivity left it for the span
SOLO_PATH = SPAN_FORMS + ("ccp_eval", "grow_pair", "btree_eval")
SYMBOL = {"connectivity": "connectivity_kernel<false>",
          "connectivity_span": "connectivity_kernel<true>"}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- phase 3 --

def kernel_graphs(nmax: int):
    """32 real generator graphs of the nmax bucket."""
    if nmax == 16:
        return gen.mixed_stream(32, seed=0, sizes=(12, 13, 14, 15, 16))
    makers = [lambda s: gen.chain(8, s), lambda s: gen.cycle(7, s),
              lambda s: gen.star(6, s), lambda s: gen.job_like(8, s),
              lambda s: gen.snowflake(8, s), lambda s: gen.clique(5, s),
              lambda s: gen.musicbrainz_query(8, 100 + s)]
    return [makers[i % len(makers)](i) for i in range(32)]


def kernel_inputs(graphs, bcap: int, nmax: int, L: int, seed: int):
    """Lanes over the first bcap graphs: sets inside each query's n bits,
    random sub/r, block a subset of S, ub/vb the endpoints of real edges."""
    rng = np.random.default_rng(seed)
    gs = graphs[:bcap]
    adj = np.zeros((bcap, nmax), np.int32)
    for q, g in enumerate(gs):
        for (u, v) in g.edges:
            adj[q, u] |= 1 << v
            adj[q, v] |= 1 << u
    qid = rng.integers(0, bcap, L).astype(np.int32)
    n_q = np.array([g.n for g in gs])[qid]
    S = (rng.integers(1, 1 << 30, L) & ((1 << n_q) - 1)).astype(np.int32)
    S[S == 0] = 1
    e_pick = [np.array(g.edges, np.int32) for g in gs]
    uv = np.stack([e_pick[q][rng.integers(0, len(e_pick[q]))] for q in qid])
    lanes = {"S": S, "qid": qid,
             "sub": rng.integers(0, 1 << 16, L).astype(np.int32),
             "r": rng.integers(0, 1 << 16, L).astype(np.int32),
             "block": (S & rng.integers(0, 1 << 16, L)).astype(np.int32),
             "ub": (1 << uv[:, 0]).astype(np.int32),
             "vb": (1 << uv[:, 1]).astype(np.int32)}
    return ({k: torch.from_numpy(v).to(DEV) for k, v in lanes.items()},
            torch.from_numpy(adj).to(DEV))


def solo_graphs(nmax: int):
    """Two real generator graphs of the solo nmax bucket."""
    return {8: [gen.chain(8, 1), gen.cycle(7, 2)],
            16: [gen.musicbrainz_query(16, 7), gen.clique(9, 2)],
            24: [gen.musicbrainz_query(20, 11), gen.snowflake(20, 1)],
            30: [gen.chain(25, 1), gen.musicbrainz_query(26, 3)]}[nmax]


def solo_inputs(g, nmax: int, L: int, seed: int):
    """Lanes over one query: S inside its n bits, sub any rank below 2^30,
    lb a subset of S, rb a subset of S & ~lb, (ub, vb) its edges' endpoints
    and qid 0 (the one-row table of the solo tree evaluate)."""
    rng = np.random.default_rng(seed)
    S = (rng.integers(1, 1 << 30, L) & ((1 << g.n) - 1)).astype(np.int32)
    S[S == 0] = 1
    lb = (S & rng.integers(0, 1 << 30, L)).astype(np.int32)
    uv = np.array(g.edges, np.int32)[rng.integers(0, g.m, L)]
    lanes = {"S": S, "sub": rng.integers(0, 1 << 30, L).astype(np.int32),
             "lb": lb,
             "rb": (S & ~lb & rng.integers(0, 1 << 30, L)).astype(np.int32),
             "ub": (1 << uv[:, 0]).astype(np.int32),
             "vb": (1 << uv[:, 1]).astype(np.int32),
             "qid": np.zeros(L, np.int32)}
    return ({k: torch.from_numpy(v).to(DEV) for k, v in lanes.items()},
            adj_table(g, nmax))


def adj_table(g, nmax: int):
    """One query's int32[nmax] adjacency table on the card."""
    adj = np.zeros(nmax, np.int32)
    for (u, v) in g.edges:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    return torch.from_numpy(adj).to(DEV)


def binom_on_card(nmax: int):
    return torch.from_numpy(ur.binom_table(nmax)).to(DEV)


def span_inputs(g, nmax: int, count: int, seed: int):
    """connectivity_span arguments: ``count`` ranks of the query's middle
    level from a random start (past the level's end where the level is
    smaller than ``count``: such ranks unrank all the same)."""
    k = g.n // 2
    rng = np.random.default_rng(seed)
    rank0 = int(rng.integers(0, max(1, comb(g.n, k) - count)))
    return (k, rank0, count, binom_on_card(nmax), adj_table(g, nmax), nmax)


def dpsub_inputs(g, nmax: int, chunk: int, seed: int):
    """ccp_eval_dpsub arguments over a list of 4096 sets inside the query's
    n bits, from a random (set, subset) start: at small i the chunk runs
    past the list's end (dead lanes, then the clamped gather)."""
    rng = np.random.default_rng(seed)
    i = int(rng.integers(2, g.n + 1))
    all_sets = rng.integers(1, 1 << g.n, 4096).astype(np.int32)
    return (torch.from_numpy(all_sets).to(DEV), int(rng.integers(0, 2048)),
            int(rng.integers(0, 2048)), int(rng.integers(0, 1 << i)), i,
            adj_table(g, nmax), nmax, chunk)


def d4_span():
    """d4's largest filter span: chain(25), level 12, all 5,200,300 ranks."""
    g = gen.chain(25, seed=1)
    return (12, 0, comb(25, 12), binom_on_card(30), adj_table(g, 30), 30)


def d3_chunk():
    """The first chunk of d3's busiest DPSUB level (the most lanes): the
    level's connected sets as all_sets, as the engine lays them out."""
    g = gen.musicbrainz_query(17, seed=11)
    adj, binom = adj_table(g, 24), binom_on_card(24)
    levels = {}
    for i in range(2, g.n + 1):
        S, conn = ref.connectivity_span_ref(i, 0, comb(g.n, i), binom, adj, 24)
        levels[i] = S[conn != 0]
    i = max(levels, key=lambda i: len(levels[i]) << i)
    return (levels[i].contiguous(), 0, 0, 0, i, adj, 24, L_MAIN)


def lane_args(name, lanes, adj, nmax):
    return (*[lanes[k] for k in KERNELS[name][0]], adj, nmax)


def call(name, args, plain=False):
    fn = getattr(ref, f"{name}_ref") if plain else getattr(ops, name)
    out = fn(*args)
    return out if isinstance(out, tuple) else (out,)


def event_ms(fn, reps: int) -> float:
    """Card time per call of ``fn``.  A sleep kernel queued first keeps the
    card busy while the host enqueues the calls, so the events time the
    launches back to back and not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def op_count(name, lanes, adj, nmax) -> int:
    """int32 operations the kernel's walks need on these inputs: a fixed
    per-lane cost plus OPS_PER_STEP per set bit visited (pdep over the
    mask, neighbours over the source, one expansion per reached vertex)."""
    adjq = adj if name in SOLO else adj[lanes["qid"].clamp(0, adj.shape[0] - 1)]
    pc = bs.popcount
    S = lanes["S"]
    nm = (1 << nmax) - 1

    def reach(src, restrict, rows):
        return pc(bs.grow_rows(src, restrict, rows) & nm)

    def ccp_steps(lb, rb):
        live = (lb != 0) & (rb != 0)
        cross = live & ((bs.neighbors_rows(lb, adjq) & rb) != 0)
        return (pc(lb & nm) * live + cross * (reach(bs.lsb(lb), lb, adjq)
                                              + reach(bs.lsb(rb), rb, adjq)))

    if name in ("connectivity", "bconnectivity"):
        steps = reach(bs.lsb(S), S, adjq)
    elif name == "grow_pair":
        steps = reach(lanes["lb"], S & ~lanes["rb"], adjq)
    elif name in ("ccp_eval", "bccp_eval"):
        lb = bs.pdep(lanes["sub"], S, nmax)
        steps = pc(S & nm) + ccp_steps(lb, S & ~lb)
    elif name == "btree_eval":
        ub, vb = lanes["ub"], lanes["vb"]
        sh = torch.arange(nmax, dtype=torch.int32, device=S.device)
        excl = (torch.where(((ub[:, None] >> sh) & 1) == 1, vb[:, None], 0)
                | torch.where(((vb[:, None] >> sh) & 1) == 1, ub[:, None], 0))
        steps = reach(ub, S, adjq & ~excl)
    else:
        blk = lanes["block"]
        lb = bs.pdep(lanes["r"], blk, nmax)
        rb = blk & ~lb
        steps = pc(blk & nm) + ccp_steps(lb, rb) + reach(lb, S & ~rb, adjq)
    return int(steps.to(torch.int64).sum()) * OPS_PER_STEP \
        + OPS_PER_LANE * S.numel()


def check(name, args, where: str) -> int:
    """Kernel vs plain version on the same card tensors, bit for bit."""
    got = call(name, args)
    want = call(name, args, plain=True)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              if a.numel() else 0 for a, b in zip(got, want))
    if err != 0 or any(a.dtype != torch.int32 for a in got):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{where}: max |diff| {err}")
    return err


def lane_work(name, lanes, adj, nmax):
    """(bytes, int32 operations) of a lane kernel's call on these lanes."""
    n_in, n_out, _ = KERNELS[name]
    nbytes = 4 * lanes["S"].numel() * (len(n_in) + n_out) + adj.numel() * 4
    return nbytes, op_count(name, lanes, adj, nmax)


def span_work(args):
    """(bytes, int32 operations) of a connectivity_span call: S and conn
    written, the tables read; per lane the unrank steps it takes (from
    v = nmax - 1 down to S's lowest bit, where kk reaches 0) and the
    connectivity walk."""
    k, rank0, count, binom, adj, nmax = args
    S, _ = call("connectivity_span", args, plain=True)
    tz = bs.popcount(bs.lsb(S) - 1)
    steps = torch.where(S != 0, nmax - tz, 0)
    nbytes = 8 * count + 4 * (binom.numel() + adj.numel())
    return nbytes, (int(steps.to(torch.int64).sum()) * UNRANK_OPS_PER_STEP
                    + op_count("connectivity", {"S": S}, adj, nmax))


def dpsub_work(args):
    """(bytes, int32 operations) of a ccp_eval_dpsub call: lb, rb and ccp
    written, each distinct set entry and the table read; per lane the
    decode and the ccp_eval walks."""
    all_sets, level_off, base_set, base_sub, i, adj, nmax, chunk = args
    t = torch.arange(chunk, dtype=torch.int32, device=adj.device)
    sub_g = base_sub + t
    idx = (level_off + base_set + (sub_g >> i)).clamp(0, all_sets.numel() - 1)
    lanes = {"S": all_sets[idx], "sub": sub_g & ((1 << i) - 1)}
    nbytes = 12 * chunk + 4 * (torch.unique(idx).numel() + adj.numel())
    return nbytes, (op_count("ccp_eval", lanes, adj, nmax)
                    + DPSUB_DECODE_OPS * chunk)


def measure(name, args, row: dict, work) -> None:
    """Card time per launch, plain-version time and the bound of
    ``work = (bytes, int32 operations)``, into row."""
    nbytes, ops_n = work
    ms = event_ms(lambda: call(name, args), 100)
    plain_ms = event_ms(lambda: call(name, args, plain=True), 10)
    t_b = nbytes / HBM_BYTES_S * 1e3
    t_o = ops_n / INT32_OPS_S * 1e3
    row.update(ms=ms, plain_ms=plain_ms, bytes=nbytes, int32_ops=ops_n,
               bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations")


def phase_kernels():
    """Bit-exact checks at every shape; times and bounds at the main one."""
    rows = {name: {"max_abs_err": 0} for name in KERNELS}
    for nmax in (8, 16):
        graphs = kernel_graphs(nmax)
        for bcap in (4, 32):
            for L in (L_MAIN, 1, 129, 32767):
                lanes, adj = kernel_inputs(graphs, bcap, nmax, L,
                                           seed=nmax * 1000 + bcap * 10 + L)
                for name in BATCHED:
                    args = lane_args(name, lanes, adj, nmax)
                    err = check(name, args, f"nmax={nmax} bcap={bcap} L={L}")
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
                    if (nmax, bcap, L) == (16, 32, L_MAIN):
                        measure(name, args, rows[name],
                                lane_work(name, lanes, adj, nmax))
                log(f"kernels ok nmax={nmax} bcap={bcap} L={L}")
    for nmax in (8, 16, 24, 30):
        for gi, g in enumerate(solo_graphs(nmax)):
            for L in (L_MAIN, 1, 129, 32767):
                lanes, adj = solo_inputs(g, nmax, L, seed=nmax * 1000 + gi * 10 + L)
                for name in SOLO_CHECKED:
                    table = adj[None, :].contiguous() if name == "btree_eval" else adj
                    args = lane_args(name, lanes, table, nmax)
                    err = check(name, args,
                                f"nmax={nmax} n={g.n} L={L} (one table)")
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
                    if (nmax, gi, L) == (24, 0, L_MAIN) and name in SOLO:
                        measure(name, args, rows[name],
                                lane_work(name, lanes, adj, nmax))
                for name, args in (("connectivity_span",
                                    span_inputs(g, nmax, L, seed=L + nmax)),
                                   ("ccp_eval_dpsub",
                                    dpsub_inputs(g, nmax, L, seed=L + nmax))):
                    err = check(name, args, f"nmax={nmax} n={g.n} L={L} "
                                f"(lanes built in the kernel)")
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
                    if (nmax, gi, L, name) == (24, 0, L_MAIN, "connectivity_span"):
                        at_l = {}
                        measure(name, args, at_l, span_work(args))
                        log_row(name, at_l, f"count={L} k={args[0]} nmax=24")
                log(f"solo kernels ok nmax={nmax} n={g.n} L={L}")
    # the main path's own shapes: d4's largest span, d3's busiest level
    args = d4_span()
    rows["connectivity_span"]["max_abs_err"] = max(
        rows["connectivity_span"]["max_abs_err"],
        check("connectivity_span", args, "d4 level 12 span"))
    measure("connectivity_span", args, rows["connectivity_span"], span_work(args))
    args = d3_chunk()
    rows["ccp_eval_dpsub"]["max_abs_err"] = max(
        rows["ccp_eval_dpsub"]["max_abs_err"],
        check("ccp_eval_dpsub", args, "d3 busiest level"))
    measure("ccp_eval_dpsub", args, rows["ccp_eval_dpsub"], dpsub_work(args))
    log(f"solo kernels ok at d4's level-12 span and d3's level-{args[4]} chunk")
    for name, row in rows.items():
        at = ("nmax=24 (one table)" if name in SOLO else
              "count=5200300 k=12 nmax=30 (d4's level-12 span)"
              if name == "connectivity_span" else
              f"L={L_MAIN} nmax=24 i={args[4]} (d3's busiest level)"
              if name == "ccp_eval_dpsub" else "nmax=16 bcap=32")
        log_row(name, row, at)
    return rows


def log_row(name, row, at):
    log(f"kernel {name}: {row['ms'] * 1e3:.2f} us/launch, plain "
        f"{row['plain_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.4f} us "
        f"({row['bound_by']}: {row['bytes']} B, {row['int32_ops']} int32 ops) "
        f"at {at}")


# ---------------------------------------------------------------- phase 4 --

def rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def ulps(a: float, b: float) -> int:
    ia = np.array([a], np.float32).view(np.int32)[0]
    ib = np.array([b], np.float32).view(np.int32)[0]
    return abs(int(ia) - int(ib))


def run_stream(label, graphs, algorithm, n_cpu):
    """One stream on cuda: timed, validated, held against DPccp and the
    port's CPU run of its first ``n_cpu`` queries."""
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batch.optimize_many(graphs, algorithm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"stream {label}: {len(graphs)} queries ({algorithm}) in {wall:.3f} s "
        f"= {len(graphs) / wall:.2f} queries/s on cuda; launches "
        + json.dumps({k: v - before[k] for k, v in ops.LAUNCHES.items()}))
    t1 = time.perf_counter()
    for g, r in zip(graphs, res):
        validate_plan(r.plan, g)
        oracle = dpccp.solve(g)
        if rel(r.cost, oracle.cost) > 1e-4:
            raise AssertionError(f"stream {label}: cost {r.cost} vs DPccp "
                                 f"{oracle.cost} (n={g.n})")
    log(f"stream {label}: all {len(graphs)} plans valid, costs within 1e-4 "
        f"of DPccp (host check {time.perf_counter() - t1:.1f} s)")
    cpu = batch.optimize_many(graphs[:n_cpu], algorithm, device="cpu")
    worst = 0
    for i, (r, c) in enumerate(zip(res, cpu)):
        if (r.counters.evaluated, r.counters.ccp) != (c.counters.evaluated,
                                                      c.counters.ccp):
            raise AssertionError(f"stream {label} query {i}: counters "
                                 f"{r.counters} on cuda vs {c.counters} on cpu")
        if r.algorithm != c.algorithm or rel(r.cost, c.cost) > 1e-5:
            raise AssertionError(f"stream {label} query {i}: {r.algorithm} "
                                 f"{r.cost} on cuda vs {c.algorithm} {c.cost}")
        worst = max(worst, ulps(r.cost, c.cost))
    log(f"stream {label}: first {n_cpu} queries match the cpu run "
        f"(counters exact, costs within 1e-5, max {worst} ulp)")
    flights = {(r.algorithm, tuple(sorted(r.timings.items()))) for r in res}
    for algo, stages in sorted(flights):
        log(f"stream {label}: flight {algo} stage seconds "
            + json.dumps({k: round(v, 4) for k, v in stages}))
    return res


def profile(label: str, fn, names):
    """Kernel time by name and the card's busy share over one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}                      # device-side events only: no double count
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    log(f"profile {label}: wall {wall:.3f} s (profiler on), device busy "
        f"{busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall:.4f} of the window, "
        f"{sum(n for n, _ in by_name.values())} device events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for key, (n, us) in top[:12]:
        log(f"profile  {us / 1e3:10.2f} ms {n:7d} x  {key[:100]}")
    for key, (n, us) in top:
        for k in names:
            sym = re.escape(SYMBOL.get(k, f"{k}_kernel"))
            if not re.search(rf"(^|[^A-Za-z0-9_]){sym}(?![A-Za-z0-9_])", key):
                continue
            log(f"profile kernel {k}: {n} launches, "
                f"{us / n:.2f} us each, {us / 1e3:.3f} ms = "
                f"{us / max(busy_us, 1e-9):.5f} of device time")


# ---------------------------------------------------------------- phase 5 --

def solo_parts():
    """(label, graph, algorithm, options, hold against the cpu run)."""
    return [
        ("d1", gen.musicbrainz_query(20, seed=11), "mpdp", {}, True),
        ("d2", gen.snowflake(20, seed=1), "mpdp", {}, False),
        ("d3", gen.musicbrainz_query(17, seed=11), "dpsub", {}, True),
        ("d4", gen.chain(25, seed=1), "mpdp", {}, False),
        ("d5 dpsize", gen.chain(8, 1), "dpsize", {}, True),
        ("d5 dpccp", gen.cycle(9, 2), "dpccp", {}, True),
        ("d5 expand", gen.musicbrainz_query(12, 7), "mpdp", {"enum": "expand"},
         True),
    ]


def hold(label, g, r, c=None):
    """Valid plan, cost within 1e-4 of DPccp; against the cpu run c:
    algorithm, Counters exact and cost within 1e-5.  Returns the ulps."""
    validate_plan(r.plan, g)
    oracle = dpccp.solve(g)
    if rel(r.cost, oracle.cost) > 1e-4:
        raise AssertionError(f"{label}: cost {r.cost} vs DPccp {oracle.cost} "
                             f"(n={g.n})")
    if c is None:
        return None
    if (r.algorithm, r.counters.evaluated, r.counters.ccp) != \
            (c.algorithm, c.counters.evaluated, c.counters.ccp):
        raise AssertionError(f"{label}: {r.algorithm} {r.counters} on cuda vs "
                             f"{c.algorithm} {c.counters} on cpu")
    if rel(r.cost, c.cost) > 1e-5:
        raise AssertionError(f"{label}: cost {r.cost} on cuda vs {c.cost} on cpu")
    return ulps(r.cost, c.cost)


def run_solo(label, g, algorithm, opts, vs_cpu):
    """One solo query on cuda: timed, its stages and launches printed, held
    against DPccp and (vs_cpu) the port's cpu run."""
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = engine.optimize(g, algorithm, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"solo {label}: n={g.n} m={g.m} {r.algorithm} in {wall:.3f} s on cuda; "
        f"counters {r.counters}; stage seconds "
        + json.dumps({k: round(v, 4) for k, v in r.timings.items()})
        + "; launches " + json.dumps({k: v - before[k] for k, v in ops.LAUNCHES.items()
                                      if v != before[k]}))
    if algorithm != "dpccp" and opts.get("enum", "unrank") == "unrank":
        spans = sum(-(-comb(g.n, i) // engine.SPAN) for i in range(2, g.n + 1))
        got = ops.LAUNCHES["connectivity_span"] - before["connectivity_span"]
        if got != spans:
            raise AssertionError(f"solo {label}: {got} connectivity_span "
                                 f"launches for {spans} level spans")
    t1 = time.perf_counter()
    c = engine.optimize(g, algorithm, device="cpu", **opts) if vs_cpu else None
    u = hold(f"solo {label}", g, r, c)
    log(f"solo {label}: plan valid, cost within 1e-4 of DPccp"
        + (f", matches the cpu run (counters exact, {u} ulp)" if vs_cpu else "")
        + f" (host check {time.perf_counter() - t1:.1f} s)")


def run_solo_many(stream_c):
    """d5: optimize_many over an n = 20 query and stream (c) — the n = 20
    query takes the solo route, the rest batch."""
    graphs = [gen.musicbrainz_query(20, seed=5)] + stream_c
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batch.optimize_many(graphs, "auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"solo d5 optimize_many: {len(graphs)} queries "
        f"{[r.algorithm for r in res]} in {wall:.3f} s on cuda; launches "
        + json.dumps({k: v - before[k] for k, v in ops.LAUNCHES.items()
                      if v != before[k]}))
    if res[0].algorithm != "mpdp_general":
        raise AssertionError(f"the n = 20 query ran {res[0].algorithm}, not solo")
    cpu = batch.optimize_many(graphs, "auto", device="cpu")
    worst = max(hold(f"solo d5 optimize_many query {i}", g, r, c)
                for i, (g, r, c) in enumerate(zip(graphs, res, cpu)))
    log(f"solo d5 optimize_many: all plans valid, within 1e-4 of DPccp, match "
        f"the cpu run (counters exact, max {worst} ulp)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    build.library()
    log(f"build: {build.BUILD_INFO['seconds']:.2f} s "
        f"(cached={build.BUILD_INFO['cached']}) -> {build.BUILD_INFO['path']}")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("ptxas:", line.strip())

    rows = phase_kernels()
    log(f"phase kernels done at {time.perf_counter() - t_start:.1f} s")

    stream_c = [gen.chain(8, 1), gen.cycle(7, 2), gen.star(6, 3), gen.job_like(8, 4)]
    streams = [
        ("a", gen.mixed_stream(32, seed=0, sizes=(12, 13, 14, 15, 16)), "auto", 4),
        ("b", gen.mixed_stream(8, seed=1, sizes=(10, 11, 12, 13)), "dpsub", 4),
        ("c", stream_c, "auto", 4),
    ]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for label, graphs, algorithm, n_cpu in streams:
        run_stream(label, graphs, algorithm, n_cpu)
    batched = dict(ops.LAUNCHES)
    log("launches on the batched path: " + json.dumps(batched))
    missing = [k for k in BATCHED if batched[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the batched path: {missing}")
    log(f"max_memory_allocated (batched path): "
        f"{torch.cuda.max_memory_allocated()} bytes")
    profile("stream a", lambda: batch.optimize_many(streams[0][1], "auto"), BATCHED)
    log(f"phase batched path done at {time.perf_counter() - t_start:.1f} s")

    parts = solo_parts()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for label, g, algorithm, opts, vs_cpu in parts:
        run_solo(label, g, algorithm, opts, vs_cpu)
    run_solo_many(stream_c)
    solo = dict(ops.LAUNCHES)
    log("launches on the solo path: " + json.dumps(solo))
    missing = [k for k in SOLO_PATH if solo[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the solo path: {missing}")
    log(f"max_memory_allocated (solo path): "
        f"{torch.cuda.max_memory_allocated()} bytes")
    torch.cuda.empty_cache()
    d1 = parts[0]
    profile("solo d1", lambda: engine.optimize(d1[1], d1[2]), SOLO_PATH)
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")

    out = [{"name": k, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ccp_eval.cu",
            "replaces": KERNELS[k][2], "launches": batched[k] + solo[k],
            "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
            "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
            "bound_by": rows[k]["bound_by"], "library_ms": None}
           for k in KERNELS]
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
