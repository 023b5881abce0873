"""The fused evaluate epilogue: ``kernels.ops.btree_eval_prune`` and
``bgeneral_eval_prune``, which the MPDP:Tree and MPDP-general chunk bodies
of inner-join flights call in place of the decode forms and the torch
epilogue after them.

* on the CPU each wrapper's buffer equals the chunk bodies' torch
  epilogue, packed by ``ref.pack_pruned`` (the decode's plain version,
  then ``ref.tree_epilogue`` or ``ref.general_epilogue``, the epilogue of
  ``chunks._beval_tree_chunk`` and ``_beval_general_chunk`` on stacked
  and on the solo engine's one-row tables), bit for bit: on every chunk
  of batched and solo tree and general runs
  over snowflake, musicbrainz and clique graphs, and on made-up chunks
  with dead lanes, clamped gathers and pair indices, padding pairs, empty
  and all-INF segments, ties of equal cost with different left bitmaps,
  and segments across warps and blocks;
* ``pack_pruned`` and ``unpack_pruned`` are inverses, bit for bit;
* ``engine.eval_chunks`` counts every evaluate chunk body's result and
  ``engine.fused_chunks`` each fused one: all the chunks of inner-join
  tree and general flights, batched, sharded, on the lattice and solo,
  none of typed, DPSUB and DPSIZE ones, and in a typed sharded flight
  those of a shard that holds only padding;
* the launch checks refuse a bad memo;
* ``gpu``-marked: the CUDA kernels against the torch epilogue on the same
  card tensors, bit for bit, on the same runs and made-up chunks, and whole
  runs with the fused epilogue against runs with the torch one.

This file imports no JAX and nothing from ``tests``, so it runs on the
card too.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import batch as tbatch, chunks as tchunks
from repro_torch.core import engine as teng, lattice as tlat
from repro_torch.core import bitset as bs, shard as tshard, telemetry
from repro_torch.kernels import ops, ref
from repro_torch.workloads import generators as gen

I32_MIN = -(1 << 31)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# ------------------------------------------------------ the torch epilogue --

def plain_tree(all_sets, eoff, loff, soff, seg0, m_b, emu_b, emv_b, adj_b,
               memo_cost, memo_rows, nmax, nseg, chunk):
    """What ``btree_eval_prune`` replaces, packed: the decode and the
    epilogue of ``chunks._beval_tree_chunk`` (``ref.tree_epilogue``), on
    stacked tables or the solo engine's one-row ones."""
    lanes = ref.btree_eval_decode_ref(all_sets, eoff, loff, soff, seg0, m_b,
                                      emu_b, emv_b, adj_b, nmax, nseg, chunk)
    return ref.tree_epilogue(lanes, adj_b, memo_cost, memo_rows, nmax, nseg)


def plain_general(pairs, n_pairs, lane_count, adj_b, memo_cost, memo_rows,
                  nmax, chunk):
    """What ``bgeneral_eval_prune`` replaces, packed: the decode and the
    epilogue of ``chunks._beval_general_chunk``
    (``ref.general_epilogue``), on stacked tables or the solo engine's
    one-row one."""
    lanes = ref.bgeneral_eval_decode_ref(pairs, n_pairs, lane_count, adj_b,
                                         nmax, chunk)
    return ref.general_epilogue(lanes, pairs.shape[1], adj_b, memo_cost,
                                memo_rows, nmax)


PLAIN = {"btree_eval_prune": plain_tree, "bgeneral_eval_prune": plain_general}
BCAP_ARG = {"btree_eval_prune": 8, "bgeneral_eval_prune": 3}


def hold(name, args, label, fn=None):
    """The wrapper (or ``fn``) against the torch epilogue on the same
    tensors, bit for bit; returns its buffer and the buffer unpacked."""
    buf = (fn or getattr(ops, name))(*args)
    want = PLAIN[name](*args)
    assert buf.dtype == torch.int64 and buf.device == args[0].device
    assert buf.shape == want.shape, label
    np.testing.assert_array_equal(buf.cpu().numpy(), want.cpu().numpy(),
                                  err_msg=label)
    return buf, ops.unpack_pruned(buf.cpu().numpy(),
                                  args[BCAP_ARG[name]].shape[0])


class Held:
    """Holds every call of the fused wrappers against the torch epilogue
    (``hold``, on a chunk's own buffer) for the test's life (``mp``: its
    monkeypatch), then makes the call as the engine made it (into the
    device fold's ``keys``/``counts`` where it gave them); ``calls``
    counts them by name."""

    def __init__(self, mp):
        self.calls = {k: 0 for k in PLAIN}
        for k in PLAIN:
            real = getattr(ops, k)
            mp.setattr(ops, k, self._held(k, real))

    def _held(self, name, real):
        def wrapper(*args, **targets):
            buf, _ = hold(name, args, f"{name} call {self.calls[name]}", real)
            self.calls[name] += 1
            return real(*args, **targets) if targets.get("keys") is not None \
                else buf
        return wrapper


# ---------------------------------------------------------------- runs --

BATCHED_RUNS = {
    "tree_snowflake": ("mpdp_tree", lambda: [gen.snowflake(10, 1),
                                             gen.snowflake(12, 2),
                                             gen.snowflake(9, 3)], 256),
    "general_musicbrainz": ("mpdp_general",
                            lambda: [gen.musicbrainz_query(10, 1),
                                     gen.musicbrainz_query(12, 2),
                                     gen.musicbrainz_query(8, 3)], 256),
    "general_clique": ("mpdp_general", lambda: [gen.clique(8, 1),
                                                gen.clique(7, 2)], 512),
}
SOLO_RUNS = {
    "tree_snowflake": ("mpdp_tree", lambda: gen.snowflake(13, 2), 256),
    "general_musicbrainz": ("mpdp_general",
                            lambda: gen.musicbrainz_query(12, 7), 512),
    "general_clique": ("mpdp_general", lambda: gen.clique(9, 1), 512),
}


def batched_run(key, device):
    space, graphs, chunk = BATCHED_RUNS[key]
    return tbatch.BatchEngine(graphs(), chunk=chunk, algorithm=space,
                              device=device).run()


def solo_run(key, device):
    space, g, chunk = SOLO_RUNS[key]
    return teng.optimize(g(), space, chunk=chunk, device=device)


def held_run(mp, run, key, device) -> dict:
    held = Held(mp)
    run(key, device)
    assert sum(held.calls.values()) > 3, held.calls
    return held.calls


@pytest.mark.parametrize("key", list(BATCHED_RUNS))
def test_batched_chunks_match_torch_epilogue(key, monkeypatch):
    calls = held_run(monkeypatch, batched_run, key, "cpu")
    print(f"batched {key}: {calls}")


@pytest.mark.parametrize("key", list(SOLO_RUNS))
def test_solo_chunks_match_torch_epilogue(key, monkeypatch):
    calls = held_run(monkeypatch, solo_run, key, "cpu")
    print(f"solo {key}: {calls}")


# --------------------------------------------------------- made-up chunks --

def adj_rows(graphs, bcap: int, nmax: int) -> np.ndarray:
    adj = np.zeros((bcap, nmax), np.int32)
    for q, g in enumerate(graphs):
        for u, v in g.edges:
            adj[q, u] |= 1 << v
            adj[q, v] |= 1 << u
    return adj


def made_memo(rng, size: int, memo: str, region: int):
    """memo_cost, memo_rows float32[size]: ``random`` costs with some INF
    and random log2 rows; ``tie`` every entry alike, so that each segment's
    splits tie and the larger left bitmap must win; ``inf`` random, with
    query 0's region (``region`` entries) all INF, so its segments hold
    only INF lanes."""
    if memo == "tie":
        return (np.full(size, 1000.0, np.float32),
                np.full(size, 20.0, np.float32))
    cost = rng.uniform(1.0, 1e6, size).astype(np.float32)
    cost[rng.random(size) < 0.1] = np.inf
    rows = rng.uniform(0.0, 60.0, size).astype(np.float32)
    if memo == "inf":
        cost[:region] = np.inf
    return cost, rows


def tree_graphs():
    return [gen.snowflake(12, 1), gen.musicbrainz_query(14, 2),
            gen.clique(6, 3), gen.snowflake(16, 4),
            gen.musicbrainz_query(9, 5),
            gen.chain(11, 6), gen.cycle(8, 7)]


def tree_case(chunk: int, seed: int, memo: str, device):
    """btree_eval_prune arguments laid out as ``BatchEngine._eval_dispatch``
    lays them out over seven graphs and one padding query (bcap 8, nmax
    16): set lists back to back in ``all_sets``, the last query's base
    moved so that its last sets lie past the end (the gather clamps), the
    chunk at a random lane of the level (dead lanes past its end, the
    segment index clamped at nseg - 1)."""
    rng = np.random.default_rng(seed)
    gs, bcap, nmax = tree_graphs(), 8, 16
    B = len(gs)
    emax = 24
    m = np.zeros(bcap, np.int32)
    emu = np.zeros((bcap, emax), np.int32)
    emv = np.zeros((bcap, emax), np.int32)
    for q, g in enumerate(gs):
        m[q] = g.m
        for j, (u, v) in enumerate(g.edges):
            emu[q, j], emv[q, j] = 1 << u, 1 << v
    ns = rng.integers(1, 400, B)
    all_sets = np.concatenate([rng.integers(1, 1 << g.n, c)
                               for g, c in zip(gs, ns)]).astype(np.int32)
    soff = np.zeros(B + 1, np.int64)
    np.cumsum(ns, out=soff[1:])
    loff = np.zeros(bcap, np.int32)
    loff[:B] = soff[:B]
    loff[B - 1] = len(all_sets) - ns[B - 1] // 2 + 1
    spad = np.full(bcap, soff[B], np.int32)
    spad[:B] = soff[:B]
    eoff = np.zeros(B + 1, np.int64)
    np.cumsum(ns * m[:B], out=eoff[1:])
    lane0 = int(rng.integers(0, eoff[-1]))
    epad = tchunks._offset_rows(eoff, np.array([lane0]), bcap)[0]
    p0 = min(max(int(np.searchsorted(eoff, lane0, side="right")) - 1, 0),
             B - 1)
    seg0 = int(soff[p0] + (lane0 - eoff[p0]) // m[p0])
    cost, rows = made_memo(rng, bcap << nmax, memo, (p0 + 1) << nmax)
    on = [torch.from_numpy(a).to(device) for a in
          (all_sets, epad, loff, spad, m, emu, emv, adj_rows(gs, bcap, nmax),
           cost, rows)]
    return (*on[:4], seg0, *on[4:], nmax, chunk + 2, chunk)


def general_case(chunk: int, seed: int, memo: str, clamp: bool, device,
                 bcap: int = 4):
    """bgeneral_eval_prune arguments laid out as the engines' general
    dispatch lays them out (``chunks._pair_table``): per query up to 300
    (set, block) pairs sorted by set, half of them a block of the whole set
    (up to 2^16 lanes: a segment across many warps and blocks), the rest a
    part of it; the pair table padded (empty segments).  ``bcap`` 1: the
    solo one-row table.  ``clamp``: the offsets shifted up and ``n_pairs``
    cut (both ends of the pair clamp)."""
    rng = np.random.default_rng(seed)
    nmax = 16
    gs = [gen.clique(12, 1), gen.musicbrainz_query(16, 2),
          gen.snowflake(14, 3)][: max(bcap - 1, 1)]
    ps, pb, pq = [], [], []
    for q, g in enumerate(gs):
        S = rng.integers(1, 1 << g.n, 2000)
        blk = np.where(rng.random(2000) < 0.5, S,
                       S & rng.integers(1, 1 << g.n, 2000))
        keep = np.flatnonzero(bs.np_popcount(blk) >= 2)[: rng.integers(1, 300)]
        order = np.argsort(S[keep], kind="stable")
        ps.append(S[keep][order])
        pb.append(blk[keep][order])
        pq.append(np.full(len(keep), q))
    ps, pb, pq = (np.concatenate(x).astype(np.int32) for x in (ps, pb, pq))
    offs = np.zeros(len(ps) + 1, np.int64)
    np.cumsum(np.int64(1) << bs.np_popcount(pb).astype(np.int64), out=offs[1:])
    lane0 = int(rng.integers(0, offs[-1]))
    lane1 = min(lane0 + chunk, int(offs[-1]))
    p0 = int(np.searchsorted(offs, lane0, side="right")) - 1
    p1 = int(np.searchsorted(offs, lane1, side="left"))
    pairs = tchunks._pair_table(ps, pb, pq if bcap > 1 else None, offs, p0, p1,
                             lane0)
    n_pairs = p1 - p0
    if clamp:
        pairs[3, :n_pairs] += np.int32(rng.integers(1, chunk // 2 + 2))
        n_pairs = max(1, int((pairs[3, :n_pairs] < chunk).sum()) // 2)
    cost, rows = made_memo(rng, bcap << nmax, memo, 1 << nmax)
    on = [torch.from_numpy(a).to(device) for a in
          (pairs, adj_rows(gs, bcap, nmax), cost, rows)]
    return (on[0], n_pairs, lane1 - lane0, *on[1:], nmax, chunk)


MEMOS = ("random", "tie", "inf")
TREE_CASES = [(chunk, memo) for chunk in (1, 129, 4096) for memo in MEMOS]
GENERAL_CASES = [(chunk, memo, clamp, bcap) for chunk in (1, 129, 4096)
                 for memo in MEMOS for clamp in (False, True)
                 for bcap in (4, 1)]


def tree_made_up(chunk, memo, device):
    for seed in range(3):
        _, (sc, sl, ev, _) = hold(
            "btree_eval_prune", tree_case(chunk, seed, memo, device),
            f"chunk={chunk} memo={memo} seed={seed}")
        if chunk == 4096:
            assert (sl == I32_MIN).any() and ev.sum() > 0  # empty segments
            if memo == "tie":
                fin = np.isfinite(sc)
                assert fin.any() and len(np.unique(sc[fin])) < fin.sum()


def general_made_up(chunk, memo, clamp, bcap, device):
    for seed in range(3):
        _, (sc, sl, ev, cc) = hold(
            "bgeneral_eval_prune",
            general_case(chunk, seed, memo, clamp, device, bcap),
            f"chunk={chunk} memo={memo} clamp={clamp} bcap={bcap} seed={seed}")
        assert (sl == I32_MIN).any()                  # padding pairs
        if memo == "inf" and bcap == 1:               # all-INF segments
            assert not np.isfinite(sc).any()
            assert set(np.unique(sl)) <= {0, I32_MIN}


@pytest.mark.parametrize("chunk,memo", TREE_CASES)
def test_tree_made_up_chunks_match_torch_epilogue(chunk, memo):
    tree_made_up(chunk, memo, "cpu")


@pytest.mark.parametrize("chunk,memo,clamp,bcap", GENERAL_CASES)
def test_general_made_up_chunks_match_torch_epilogue(chunk, memo, clamp, bcap):
    general_made_up(chunk, memo, clamp, bcap, "cpu")


def test_pack_and_unpack_are_inverses():
    rng = np.random.default_rng(0)
    n, bcap = 1000, 8
    cost = rng.uniform(0.0, 1e30, n).astype(np.float32)
    cost[::7] = np.inf
    cost[::11] = 0.0
    left = rng.integers(I32_MIN, 1 << 31, n, dtype=np.int64).astype(np.int32)
    left[::13] = I32_MIN
    ev = rng.integers(0, 1 << 20, bcap).astype(np.int32)
    cc = rng.integers(0, 1 << 40, bcap)              # int64 counts: no wrap
    buf = ref.pack_pruned(*map(torch.from_numpy, (cost, left, ev, cc)))
    assert buf.dtype == torch.int64 and buf.shape == (n + 2 * bcap,)
    got = ops.unpack_pruned(buf.numpy(), bcap)
    np.testing.assert_array_equal(got[0].view(np.int32), cost.view(np.int32))
    assert got[2].dtype == got[3].dtype == np.int64
    for a, b in zip(got[1:], (left, ev, cc)):
        np.testing.assert_array_equal(a, b)
    # the key of an empty segment, all zero, reads (INF, INT32_MIN)
    got = ops.unpack_pruned(np.zeros(3 + 2, np.int64), 1)
    assert np.isposinf(got[0]).all() and (got[1] == I32_MIN).all()


# ------------------------------------------------------------- counters --

TYPED_TREES = [gen.typed_query(9, seed=3, base="chain"),
               gen.typed_query(10, seed=1, base="snowflake")]
TYPED = [gen.typed_query(9, seed=2, base="job"),
         gen.typed_query(10, seed=4, base="musicbrainz")]
INNER = [gen.musicbrainz_query(10, 1), gen.clique(7, 2)]
TREES = [gen.snowflake(10, 1), gen.snowflake(11, 2)]
MESH = ["cpu", "cpu"]

# key -> (which chunks run fused: "all", "none" or "some", the run)
COUNTER_RUNS = {
    "batched_tree": ("all", lambda: tbatch.BatchEngine(
        TREES, chunk=256, algorithm="mpdp_tree", device="cpu").run()),
    "batched_general": ("all", lambda: tbatch.BatchEngine(
        INNER, chunk=256, algorithm="mpdp_general", device="cpu").run()),
    "batched_general_pipelined": ("all", lambda: tbatch.BatchEngine(
        INNER, chunk=256, algorithm="mpdp_general", pipeline=True,
        device="cpu").run()),
    "sharded_tree": ("all", lambda: tshard.ShardedBatchEngine(
        TREES, mesh=MESH, chunk=256, algorithm="mpdp_tree").run()),
    "sharded_general": ("all", lambda: tshard.ShardedBatchEngine(
        INNER, mesh=MESH, chunk=256, algorithm="mpdp_general").run()),
    "lattice_tree": ("all", lambda: tlat.LatticeShardedEngine(
        TREES[0], mesh=MESH, chunk=256, algorithm="mpdp_tree").run()),
    "lattice_general": ("all", lambda: tlat.LatticeShardedEngine(
        INNER[0], mesh=MESH, chunk=256, algorithm="mpdp_general").run()),
    "solo_tree": ("all", lambda: teng.optimize(TREES[1], "mpdp_tree",
                                               chunk=256, device="cpu")),
    "solo_general": ("all", lambda: teng.optimize(INNER[1], "mpdp_general",
                                                  chunk=256, device="cpu")),
    "optimize_many_auto": ("all", lambda: tbatch.optimize_many(
        TREES + INNER, "auto", chunk=256, device="cpu")),
    "batched_dpsub": ("none", lambda: tbatch.BatchEngine(
        INNER, chunk=256, algorithm="dpsub", device="cpu").run()),
    "solo_dpsub": ("none", lambda: teng.optimize(INNER[0], "dpsub", chunk=256,
                                                 device="cpu")),
    "solo_dpsize": ("none", lambda: teng.optimize(INNER[0], "dpsize",
                                                  chunk=256, device="cpu")),
    "typed_batched_tree": ("none", lambda: tbatch.BatchEngine(
        TYPED_TREES, chunk=256, algorithm="mpdp_tree", device="cpu").run()),
    "typed_batched_general": ("none", lambda: tbatch.BatchEngine(
        TYPED, chunk=256, algorithm="mpdp_general", device="cpu").run()),
    "typed_solo_general": ("none", lambda: teng.optimize(
        TYPED[0], "mpdp_general", chunk=256, device="cpu")),
    "typed_sharded_general": ("none", lambda: tshard.ShardedBatchEngine(
        TYPED, mesh=MESH, chunk=256, algorithm="mpdp_general").run()),
    # one typed query over two shards: the other shard holds only padding
    "typed_sharded_pad": ("some", lambda: tshard.ShardedBatchEngine(
        TYPED[:1], mesh=MESH, chunk=256, algorithm="mpdp_general").run()),
}

BODIES = ((tchunks, "_beval_dpsub_chunk"), (tchunks, "_beval_tree_chunk"),
          (tchunks, "_beval_general_chunk"), (teng, "_eval_dpsub_chunk"),
          (teng, "_eval_dpsize_chunk"))


def spy_bodies(mp) -> dict:
    """Counts, for the test's life, the evaluate chunk bodies' calls and
    those that returned a fused chunk's ``Pruned``."""
    seen = {"calls": 0, "fused": 0}

    def spied(real):
        def body(*args, **kw):
            out = real(*args, **kw)
            seen["calls"] += 1
            seen["fused"] += isinstance(out, tchunks.Pruned)
            return out
        return body
    for m, name in BODIES:
        mp.setattr(m, name, spied(getattr(m, name)))
    return seen


@pytest.fixture
def recorder():
    was = telemetry._ON
    telemetry.clear()
    telemetry.enable()
    yield
    if not was:
        telemetry.disable()
    telemetry.clear()


def total(name: str) -> int:
    return sum(k for (n, _), k in telemetry.counts().items() if n == name)


@pytest.mark.parametrize("key", list(COUNTER_RUNS))
def test_fused_chunks_count_inner_tree_and_general_chunks(key, recorder,
                                                          monkeypatch):
    fused, run = COUNTER_RUNS[key]
    assert all(g.is_tree() for g in TREES + TYPED_TREES)
    assert all(g.typed for g in TYPED + TYPED_TREES)
    seen = spy_bodies(monkeypatch)
    launches = dict(ops.LAUNCHES)
    run()
    evals = total("engine.eval_chunks")
    assert evals > 2
    assert evals == seen["calls"]
    assert total("engine.fused_chunks") == seen["fused"]
    assert seen["fused"] == {"all": evals, "none": 0}.get(fused, seen["fused"])
    if fused == "some":
        assert 0 < seen["fused"] < evals
    assert ops.LAUNCHES == launches               # the CPU launches none


# ---------------------------------------------------------- launch checks --

def test_prune_launch_checks_refuse_a_bad_memo():
    tree = tree_case(129, 0, "random", "cpu")
    general = general_case(129, 0, "random", False, "cpu")
    for launch, args, at in ((ops._launch_tree_prune, tree, 9),
                             (ops._launch_general_prune, general, 4)):
        cost, rows = args[at], args[at + 1]
        for bad in ({at: cost.double()}, {at + 1: rows[:-1]},
                    {at: cost.reshape(2, -1)}, {at + 1: rows[::2]}):
            a = list(args)
            for k, v in bad.items():
                a[k] = v
            with pytest.raises(ValueError, match="memo"):
                launch(*a)


# ------------------------------------------------------------ on the card --

@pytest.mark.gpu
@pytest.mark.parametrize("key", list(BATCHED_RUNS))
def test_cuda_batched_chunks_match_torch_epilogue(key, monkeypatch):
    needs_card()
    calls = held_run(monkeypatch, batched_run, key, "cuda")
    print(f"cuda batched {key}: {calls}")


@pytest.mark.gpu
@pytest.mark.parametrize("key", list(SOLO_RUNS))
def test_cuda_solo_chunks_match_torch_epilogue(key, monkeypatch):
    needs_card()
    calls = held_run(monkeypatch, solo_run, key, "cuda")
    print(f"cuda solo {key}: {calls}")


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,memo", TREE_CASES)
def test_cuda_tree_made_up_chunks_match_torch_epilogue(chunk, memo):
    needs_card()
    tree_made_up(chunk, memo, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,memo,clamp,bcap", GENERAL_CASES)
def test_cuda_general_made_up_chunks_match_torch_epilogue(chunk, memo, clamp,
                                                         bcap):
    needs_card()
    general_made_up(chunk, memo, clamp, bcap, "cuda")


def unfused(mp):
    """Send every chunk body to the torch epilogue."""
    mp.setattr(tchunks, "_fused", lambda targs: False)


@pytest.mark.gpu
def test_cuda_runs_equal_runs_with_the_torch_epilogue():
    """optimize_many over snowflake, musicbrainz and clique queries and
    solo runs, on the card: costs, plans and counters with the fused
    epilogue equal those with the torch one, bit for bit."""
    needs_card()
    graphs = ([gen.snowflake(n, n) for n in (12, 14, 16)]
              + [gen.musicbrainz_query(n, n) for n in (12, 14, 16)]
              + [gen.clique(n, n) for n in (10, 12)])
    solo = [(gen.musicbrainz_query(18, 1), "auto"),
            (gen.snowflake(18, 2), "mpdp_tree"), (gen.clique(13, 3), "auto")]

    def runs():
        out = tbatch.optimize_many(graphs, "auto", device="cuda")
        return out + [teng.optimize(g, a, device="cuda") for g, a in solo]

    ops.reset_launches()
    fused = runs()
    assert ops.LAUNCHES["btree_eval_prune"] > 0
    assert ops.LAUNCHES["bgeneral_eval_prune"] > 0
    assert ops.LAUNCHES["btree_eval_decode"] == 0
    assert ops.LAUNCHES["bgeneral_eval_decode"] == 0
    with pytest.MonkeyPatch.context() as mp:
        unfused(mp)
        ops.reset_launches()
        eager = runs()
        assert ops.LAUNCHES["btree_eval_prune"] == 0
        assert ops.LAUNCHES["bgeneral_eval_prune"] == 0
    for i, (a, b) in enumerate(zip(fused, eager)):
        assert np.float32(a.cost).view(np.int32) == \
            np.float32(b.cost).view(np.int32), f"query {i}"
        assert repr(a.plan) == repr(b.plan), f"query {i}"
        assert (a.counters.evaluated, a.counters.ccp) == \
            (b.counters.evaluated, b.counters.ccp), f"query {i}"
