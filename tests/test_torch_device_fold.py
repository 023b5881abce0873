"""The device fold of the fused evaluate chunks (``chunks.DeviceFold``):
a single-device engine's inner-join MPDP:Tree and MPDP-general chunks fold
their keys into one buffer a level and their counts into one int64 buffer
a flight, and one ``ops.commit_keys`` launch a level writes the memo, in
place of the host's fetch, merge and scatter (``chunks.ChunkResults``).

* ``BatchEngine`` (MPDP:Tree over snowflakes, MPDP-general over cyclic
  musicbrainz queries whose sets have several blocks), ``ExactEngine``
  (tree and general) and ``ShardedBatchEngine`` (two logical CPU shards),
  at chunk 256 (levels over many chunks, pairs across two chunks) and
  32,768, at ``pend_window`` 0 and 8, pipelined and not: the memo's cost
  and left arrays, ``Counters`` and ``chunks_dispatched`` equal the host
  fold's bit for bit (``chunks._folds`` patched to send every chunk to
  ``ChunkResults``);
* a constructed level where every split of a set costs zero (the memo's
  costs -0.0, its rows -inf), the candidates of one set across two
  chunks: both folds keep the larger left bitmap and write +0.0;
* ``ops.commit_keys`` and the fused forms' caller-given targets: counts
  are int64 and a target of another type raises; the keys of one memo
  entry must be consecutive;
* ``engine.eval_chunks``, ``engine.fused_chunks`` and
  ``engine.folded_chunks`` count one each per fused chunk; typed and DPSUB
  flights and the lattice still fold through ``ChunkResults`` and count
  no folded chunk;
* ``gpu``-marked: the same equalities on the card.

This file imports no JAX and nothing from ``tests``, so it runs on the
card too.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import batch as tbatch, chunks as tchunks
from repro_torch.core import engine as teng, lattice as tlat
from repro_torch.core import shard as tshard, telemetry
from repro_torch.kernels import ops, ref
from repro_torch.workloads import generators as gen


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# ---------------------------------------------------------------- runs --

TREES = [gen.snowflake(11, 1), gen.snowflake(12, 2), gen.snowflake(9, 3)]
CYCLIC = [gen.musicbrainz_query(11, 1), gen.musicbrainz_query(12, 4),
          gen.musicbrainz_query(10, 5)]
SPACE = {"tree": ("mpdp_tree", TREES), "general": ("mpdp_general", CYCLIC)}
CHUNKS = (256, 32768)
WINDOWS = [(0, False), (0, True), (8, False), (8, True)]   # (pend, pipeline)


class Spy:
    """Records, for the test's life, every ``DeviceFold.level`` index array
    and every chunk key ``DeviceFold.add`` took, by fold."""

    def __init__(self, mp):
        self.levels, self.keys, now = [], [], {}
        real_level, real_add = tchunks.DeviceFold.level, tchunks.DeviceFold.add

        def level(fold, idx, slack):
            self.levels.append(np.asarray(idx).copy())
            self.keys.append([])
            now[id(fold)] = self.keys[-1]
            return real_level(fold, idx, slack)

        def add(fold, key, out):
            now[id(fold)].append(key)
            return real_add(fold, key, out)
        mp.setattr(tchunks.DeviceFold, "level", level)
        mp.setattr(tchunks.DeviceFold, "add", add)


def host_fold(mp):
    """Send every chunk of the engines built from here on to the host
    fold (``ChunkResults``)."""
    mp.setattr(tchunks, "_folds", lambda algorithm, targs: False)


def memo_of(eng):
    """The memo's cost (as int32 bits) and left arrays of an engine, of
    every shard of a sharded one."""
    engs = getattr(eng, "shards", [eng])
    return [(e.memo_cost.view(torch.int32).cpu().numpy(),
             e.memo_left.cpu().numpy()) for e in engs]


def outcome(eng, results):
    counters = [(r.counters.evaluated, r.counters.ccp) for r in results]
    costs = [np.float32(r.cost).view(np.int32) for r in results]
    return memo_of(eng), counters, costs, eng.chunks_dispatched


def assert_same(a, b, label):
    (ma, ca, ka, da), (mb, cb, kb, db) = a, b
    for (xa, la), (xb, lb) in zip(ma, mb):
        np.testing.assert_array_equal(xa, xb, err_msg=f"{label}: memo cost")
        np.testing.assert_array_equal(la, lb, err_msg=f"{label}: memo left")
    assert ca == cb, f"{label}: counters"
    assert ka == kb, f"{label}: costs"
    assert da == db, f"{label}: chunks_dispatched"


def batched(kind, chunk, pend, pipeline, device, sharded=False):
    space, graphs = SPACE[kind]
    if sharded:
        eng = tshard.ShardedBatchEngine(
            graphs, mesh=[device] * 2, chunk=chunk, algorithm=space,
            pipeline=pipeline, pend_window=pend)
    else:
        eng = tbatch.BatchEngine(graphs, chunk=chunk, algorithm=space,
                                 pipeline=pipeline, pend_window=pend,
                                 device=device)
    return eng, eng.run()


def solo(kind, chunk, device):
    space, graphs = SPACE[kind]
    g = graphs[1]
    eng = teng.ExactEngine(g, chunk=chunk, device=device)
    getattr(eng, f"run_{space}")()
    return eng, [eng.result(space, 0.0)]


def both_folds(mp, run):
    """``run()`` with the device fold (its ``Spy``), then with the host
    fold: the two outcomes and the spy."""
    with pytest.MonkeyPatch.context() as m:
        spy = Spy(m)
        dev = outcome(*run())
    with pytest.MonkeyPatch.context() as m:
        host_fold(m)
        host = outcome(*run())
    return dev, host, spy


def check_shapes(kind, chunk, spy):
    """What the runs exercised: several chunks in a level at chunk 256,
    and for MPDP-general sets of several blocks and pairs across two
    chunks."""
    assert spy.levels, "no level folded on the device"
    chunks_a_level = max(len(k) for k in spy.keys)
    if chunk == 256:
        assert chunks_a_level >= 3
    if kind == "general":
        assert any((np.diff(idx) == 0).any() for idx in spy.levels)
        if chunk == 256:
            straddle = [a for keys in spy.keys for a, b in zip(keys, keys[1:])
                        if b[0] == a[0] + a[1] - 1]
            assert straddle, "no pair across two chunks"


@pytest.mark.parametrize("pend,pipeline", WINDOWS)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", list(SPACE))
def test_batched_device_fold_equals_host_fold(kind, chunk, pend, pipeline,
                                              monkeypatch):
    dev, host, spy = both_folds(monkeypatch, lambda: batched(
        kind, chunk, pend, pipeline, "cpu"))
    assert_same(dev, host, f"batched {kind} chunk={chunk} pend={pend} "
                           f"pipeline={pipeline}")
    check_shapes(kind, chunk, spy)


@pytest.mark.parametrize("pend,pipeline", WINDOWS)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", list(SPACE))
def test_sharded_device_fold_equals_host_fold(kind, chunk, pend, pipeline,
                                              monkeypatch):
    dev, host, spy = both_folds(monkeypatch, lambda: batched(
        kind, chunk, pend, pipeline, "cpu", sharded=True))
    assert_same(dev, host, f"sharded {kind} chunk={chunk} pend={pend} "
                           f"pipeline={pipeline}")
    check_shapes(kind, chunk, spy)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", list(SPACE))
def test_solo_device_fold_equals_host_fold(kind, chunk, monkeypatch):
    dev, host, spy = both_folds(monkeypatch, lambda: solo(kind, chunk, "cpu"))
    assert_same(dev, host, f"solo {kind} chunk={chunk}")
    check_shapes(kind, chunk, spy)


def test_counts_are_int64_until_collected():
    eng = tbatch.BatchEngine(TREES, chunk=256, algorithm="mpdp_tree",
                             device="cpu")
    eng.run_levels()
    counts = eng._fold.counts
    assert counts.dtype == torch.int64 and counts.shape == (2 * eng.bcap,)
    assert all(c.evaluated == 0 for c in eng.counters)   # not read yet
    want = counts.numpy().copy()
    rs = eng.collect()
    assert eng._fold.counts is None                      # settled once
    for q, r in enumerate(rs):
        assert (r.counters.evaluated, r.counters.ccp) == \
            (want[q], want[eng.bcap + q])
    eng.collect()
    assert (rs[0].counters.evaluated, rs[0].counters.ccp) == \
        (want[0], want[eng.bcap])


# ------------------------------------------------ a constructed zero tie --

def zero_tie(space, g, chunk, level, device, fold):
    """Level ``level`` of ``g`` on the solo engine's one-row tables, its
    memo's costs all -0.0 and rows -inf, so that every split costs +0.0:
    the chunk bodies' results folded on the device (``fold``) or on the
    host, then committed.  Returns the memo (cost bits, left) at the
    level's sets, the candidates (set, left, chunk) of the decode and the
    counts."""
    eng = teng.ExactEngine(g, chunk=chunk, device=device)
    for i in range(2, level + 1):
        sets = eng._level_sets(i)
    eng.memo_cost.fill_(-0.0)
    eng.memo_rows.fill_(float("-inf"))
    cand = []
    if space == "mpdp_tree":
        m = g.m
        acc = (tchunks.DeviceFold(1, eng.device).level(sets, chunk + 1) if fold
               else tchunks.ChunkResults(len(sets), 1, idx=sets))
        for c, lane0 in enumerate(range(0, len(sets) * m, chunk)):
            cnt = min(chunk, len(sets) * m - lane0)
            offs = eng._dev(teng._tree_offsets(eng.level_off[level],
                                               lane0 // m, lane0 % m, cnt))
            args = (eng.all_sets, offs[0:2], offs[2:3], offs[3:4], 0, eng.m1,
                    eng.emu1, eng.emv1, eng.adj1)
            S, sl, ein, _, seg = ref.btree_eval_decode_ref(
                *args, eng.nmax, chunk + 1, chunk)
            on = (ein != 0).cpu().numpy()
            cand += [(sets[lane0 // m + k], x, c) for k, x in
                     zip(seg.cpu().numpy()[on], sl.cpu().numpy()[on])]
            acc.add(lane0 // m, tchunks._beval_tree_chunk(
                eng.all_sets, offs[0:2], offs[2:3], offs[3:4], 0, eng.m1,
                eng.adj1, eng.emu1, eng.emv1, eng.memo_cost, eng.memo_rows,
                nmax=eng.nmax, chunk=chunk, nseg=chunk + 1, bcap=1,
                **acc.into(lane0 // m)))
    else:
        ps, pb = eng._find_blocks_host(sets)
        offs = tchunks._pair_offsets(pb)
        acc = (tchunks.DeviceFold(1, eng.device).level(
                   ps, tchunks._cap(chunk, 256)) if fold
               else tchunks.ChunkResults(len(sets), 1, np.searchsorted(
                   sets, ps).astype(np.int64), idx=sets))
        for c, lane0 in enumerate(range(0, int(offs[-1]), chunk)):
            lane1 = min(lane0 + chunk, int(offs[-1]))
            p0, npair, table = tchunks._pair_window(ps, pb, None, offs, lane0,
                                                    lane1)
            table = eng._dev(table)
            S, sl, _, ccp, _, p = ref.bgeneral_eval_decode_ref(
                table, npair, lane1 - lane0, eng.adj1, eng.nmax, chunk)
            on = (ccp != 0).cpu().numpy()
            cand += [(x, y, c) for x, y in zip(S.cpu().numpy()[on],
                                               sl.cpu().numpy()[on])]
            acc.add((p0, npair), tchunks._beval_general_chunk(
                table, npair, lane1 - lane0, eng.adj1, eng.memo_cost,
                eng.memo_rows, nmax=eng.nmax, chunk=chunk, bcap=1,
                **acc.into(p0)))
    got = acc.commit(eng.memo_cost, eng.memo_left)
    if fold:
        counts = acc.counts.cpu().numpy()
        got = (counts[:1], counts[1:])
    at = torch.from_numpy(sets.astype(np.int64)).to(eng.device)
    return ((eng.memo_cost[at].view(torch.int32).cpu().numpy(),
             eng.memo_left[at].cpu().numpy()), cand, got, sets)


ZERO_TIES = [("mpdp_tree", lambda: gen.star(7, 1), 4, 3),
             ("mpdp_general", lambda: gen.clique(7, 2), 12, 4),
             ("mpdp_general", lambda: gen.musicbrainz_query(10, 3), 8, 5)]


def zero_tie_case(space, g, chunk, level, device):
    (dc, dl), cand, dcounts, sets = zero_tie(space, g, chunk, level, device,
                                             True)
    (hc, hl), _, hcounts, _ = zero_tie(space, g, chunk, level, device, False)
    np.testing.assert_array_equal(dc, hc)
    np.testing.assert_array_equal(dl, hl)
    for a, b in zip(dcounts, hcounts):
        np.testing.assert_array_equal(np.asarray(a).reshape(-1),
                                      np.asarray(b).reshape(-1))
    assert (dc == 0).all()                        # +0.0: every zero alike
    best, chunks_of = {}, {}
    for s, left, c in cand:
        best[int(s)] = max(best.get(int(s), left), left)
        chunks_of.setdefault(int(s), set()).add(c)
    np.testing.assert_array_equal(dl, [best[int(s)] for s in sets])
    ties = [s for s in best if len({lf for x, lf, _ in cand if x == s}) > 1]
    assert any(len(chunks_of[s]) > 1 for s in ties), \
        "no tie of one set across two chunks"


@pytest.mark.parametrize("space,graph,chunk,level", ZERO_TIES,
                         ids=["tree_star7", "general_clique7", "general_mb10"])
def test_zero_cost_tie_keeps_the_larger_left(space, graph, chunk, level):
    zero_tie_case(space, graph(), chunk, level, "cpu")


# ------------------------------------------------------- the contracts --

def test_commit_keys_writes_finite_run_maxima():
    """Runs of one memo index take their largest key; an INF or empty key
    writes nothing, nor an index outside the memo."""
    def key(cost, left):
        hi = 0x7F800000 - int(np.float32(cost).view(np.int32))
        return (hi << 32) | ((left ^ -(1 << 31)) & 0xFFFFFFFF)
    keys = torch.tensor([key(5.0, 3), key(5.0, 9), key(7.0, 50),     # 4
                         key(np.inf, 0), 0,                          # 6
                         key(2.0, -4),                               # 1
                         key(1.0, 8), key(0.5, 2),                   # 99
                         0], dtype=torch.int64)
    idx = torch.tensor([4, 4, 4, 6, 6, 1, 99, 99], dtype=torch.int32)
    cost = torch.full((8,), 3.0)
    left = torch.full((8,), -1, dtype=torch.int32)
    ops.commit_keys(keys, idx, cost, left)
    assert cost.tolist() == [3.0, 2.0, 3.0, 3.0, 5.0, 3.0, 3.0, 3.0]
    assert left.tolist() == [-1, -4, -1, -1, 9, -1, -1, -1]
    with pytest.raises(ValueError, match="consecutive"):
        ops.commit_keys(keys, torch.tensor([4, 6, 4], dtype=torch.int32),
                        cost, left)


def test_fused_forms_refuse_bad_targets():
    eng = teng.ExactEngine(gen.musicbrainz_query(8, 1), chunk=64,
                           device="cpu")
    sets = eng._level_sets(2)
    ps, pb = eng._find_blocks_host(sets)
    offs = tchunks._pair_offsets(pb)
    lane1 = min(64, int(offs[-1]))
    p0, npair, table = tchunks._pair_window(ps, pb, None, offs, 0, lane1)
    args = (eng._dev(table), npair, lane1, eng.adj1,
            eng.memo_cost, eng.memo_rows, eng.nmax, 64)
    keys = torch.zeros(table.shape[1], dtype=torch.int64)
    counts = torch.zeros(2, dtype=torch.int64)
    assert ops.bgeneral_eval_prune(*args, keys=keys, counts=counts) is keys
    assert counts[1] > 0
    for bad in ({"counts": counts.int()}, {"keys": keys[:-1]},
                {"keys": keys.double()}, {"counts": counts[:1]}):
        kw = {"keys": keys, "counts": counts, **bad}
        with pytest.raises(ValueError, match="int64"):
            ops.bgeneral_eval_prune(*args, **kw)


# ------------------------------------------------------------- counters --

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


TYPED = [gen.typed_query(9, seed=2, base="job"),
         gen.typed_query(10, seed=4, base="musicbrainz")]
MESH = ["cpu", "cpu"]

# key -> (whether the chunks fold on the device, the run)
FOLD_RUNS = {
    "batched_tree": (True, lambda: tbatch.BatchEngine(
        TREES, chunk=256, algorithm="mpdp_tree", device="cpu").run()),
    "batched_general_pipelined": (True, lambda: tbatch.BatchEngine(
        CYCLIC, chunk=256, algorithm="mpdp_general", pipeline=True,
        device="cpu").run()),
    "sharded_general": (True, lambda: tshard.ShardedBatchEngine(
        CYCLIC, mesh=MESH, chunk=256, algorithm="mpdp_general").run()),
    "solo_tree": (True, lambda: teng.optimize(TREES[0], "mpdp_tree",
                                              chunk=256, device="cpu")),
    "solo_general": (True, lambda: teng.optimize(CYCLIC[0], "mpdp_general",
                                                 chunk=256, device="cpu")),
    "batched_dpsub": (False, lambda: tbatch.BatchEngine(
        CYCLIC[:2], chunk=256, algorithm="dpsub", device="cpu").run()),
    "solo_dpsub": (False, lambda: teng.optimize(CYCLIC[2], "dpsub",
                                                chunk=256, device="cpu")),
    "typed_batched_general": (False, lambda: tbatch.BatchEngine(
        TYPED, chunk=256, algorithm="mpdp_general", device="cpu").run()),
    "typed_solo_general": (False, lambda: teng.optimize(
        TYPED[0], "mpdp_general", chunk=256, device="cpu")),
    "lattice_tree": (False, lambda: tlat.LatticeShardedEngine(
        TREES[0], mesh=MESH, chunk=256, algorithm="mpdp_tree").run()),
    "lattice_general": (False, lambda: tlat.LatticeShardedEngine(
        CYCLIC[0], mesh=MESH, chunk=256, algorithm="mpdp_general").run()),
}


@pytest.mark.parametrize("key", list(FOLD_RUNS))
def test_folded_chunks_count_one_a_fused_chunk(key, recorder, monkeypatch):
    folds, run = FOLD_RUNS[key]
    took = {"device": 0, "host": 0}
    for cls, where in ((tchunks.DeviceFold, "device"),
                       (tchunks.ChunkResults, "host")):
        real = cls.add

        def add(acc, k, out, real=real, where=where):
            took[where] += 1
            return real(acc, k, out)
        monkeypatch.setattr(cls, "add", add)
    run()
    evals = total("engine.eval_chunks")
    assert evals > 2
    assert evals == took["device"] + took["host"]
    assert total("engine.folded_chunks") == took["device"]
    if folds:
        assert took["host"] == 0
        assert total("engine.fused_chunks") == evals
    else:
        assert took["device"] == 0
        if key.startswith("lattice"):
            assert total("engine.fused_chunks") == evals
        else:
            assert total("engine.fused_chunks") == 0


# ------------------------------------------------------------ on the card --

@pytest.mark.gpu
@pytest.mark.parametrize("pend,pipeline", [(0, False), (8, True)])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", list(SPACE))
def test_cuda_device_fold_equals_host_fold(kind, chunk, pend, pipeline,
                                           monkeypatch):
    needs_card()
    for run in (lambda: batched(kind, chunk, pend, pipeline, "cuda"),
                lambda: batched(kind, chunk, pend, pipeline, "cuda",
                                sharded=True),
                lambda: solo(kind, chunk, "cuda")):
        dev, host, _ = both_folds(monkeypatch, run)
        assert_same(dev, host, f"cuda {kind} chunk={chunk} pend={pend}")


@pytest.mark.gpu
@pytest.mark.parametrize("space,graph,chunk,level", ZERO_TIES,
                         ids=["tree_star7", "general_clique7", "general_mb10"])
def test_cuda_zero_cost_tie_keeps_the_larger_left(space, graph, chunk, level):
    needs_card()
    zero_tie_case(space, graph(), chunk, level, "cuda")
