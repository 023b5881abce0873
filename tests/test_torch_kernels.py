"""The kernels: plain PyTorch versions vs the JAX reference.

* each plain version (``repro_torch.kernels.ref``) equals the reference's
  jnp oracle (``repro.kernels.ref``) bit for bit, over the graphs of
  ``tests/test_kernels.py`` and ragged lane counts — the batched kernels
  on stacked tables (``KERNELS``), the solo-engine kernels on one query's
  table at nmax 8, 16 and 24 (``SOLO_KERNELS``);
* one small case per kernel against the Pallas kernel itself, run in
  interpret mode on the CPU as the reference's own tests run it;
* the wrappers route CPU tensors to the plain version, count no launch
  for them, and refuse what the CUDA kernels do not take;
* the solo forms that build their own lanes: ``connectivity_span``
  against the reference's jitted unrank + filter chunks
  (``repro.core.engine._filter_chunk``, concatenated, masked lanes
  dropped), ``ccp_eval_dpsub`` against the reference's DPSUB decode with
  ``pdep`` and the ccp test, dead and clamped lanes included;
* the batched forms that build their own lanes: ``bconnectivity_span``
  against the reference's ``repro.core.batch._bfilter_chunk`` over every
  chunk of each level of a mixed batch (concatenated, masked lanes
  dropped, and split per query as the port's filter splits them),
  ``btree_eval_decode`` against a jnp restatement of the reference's
  MPDP:Tree decode, dead and clamped lanes included;
* ``bccp_eval_decode`` against a jnp restatement of the reference's
  batched DPSUB decode followed by its ``bccp_eval_ref``, dead lanes and
  both ends of the segment clamp included; the port's batched DPSUB chunk
  body against the reference's (``_beval_dpsub_chunk``) call for call, as
  for the tree; the level's offset rows, copied once, against the
  per-chunk tables they replaced;
* the port's MPDP:Tree chunk body (``chunks._beval_tree_chunk``, which
  the batched and the solo engines call, the solo one at ``bcap = 1`` on
  one-row tables) against the reference's batched and solo bodies
  (``_beval_tree_chunk``, ``_eval_tree_chunk``) on the memo of a run,
  call for call: integers exact, costs within a relative 1e-5 (largest
  ULP distance printed); the solo one-row offset tables against the
  decode they replaced, lane for lane;
* ``bgeneral_eval_decode`` against a jnp restatement of the reference's
  batched MPDP-general decode (stacked tables) and of its solo one (one
  table), dead lanes, ranks past the block and both clamps of the pair
  index included; the port's MPDP-general chunk body, batched and solo
  (``chunks._beval_general_chunk``), against the reference's
  (``_beval_general_chunk``, ``_eval_general_chunk``) call for call, as
  for the tree;
* ``gpu``-marked tests hold each CUDA kernel against its plain version on
  the card (they skip without one).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from math import comb

from repro.core import batch as rbatch, bitset as rbs, engine as reng
from repro.core import unrank as rur
from repro.daemon.protocol import graph_to_wire
from repro.kernels import ccp_eval as rpallas, ref as rref
from repro.workloads import generators as rgen
from repro_torch.core import batch as tbatch, chunks as tchunks
from repro_torch.core import engine as teng
from repro_torch.core import joingraph as tjg, unrank as tur
from repro_torch.kernels import ops, ref as tref

# (inputs, jnp oracle, port plain version, Pallas wrapper)
KERNELS = {
    "bconnectivity": (("S", "qid"), rref.bconnectivity_ref,
                      tref.bconnectivity_ref, rpallas.bconnectivity),
    "bccp_eval": (("S", "sub", "qid"), rref.bccp_eval_ref,
                  tref.bccp_eval_ref, rpallas.bccp_eval),
    "btree_eval": (("S", "ub", "vb", "qid"), rref.btree_eval_ref,
                   tref.btree_eval_ref, rpallas.btree_eval),
    "bgeneral_eval": (("S", "block", "r", "qid"), rref.bgeneral_eval_ref,
                      tref.bgeneral_eval_ref, rpallas.bgeneral_eval),
}
TABLES = {
    # the tests/test_kernels.py graphs (nmax 16) and small ones (nmax 8)
    "tk16": (16, lambda: [rgen.musicbrainz_query(12, 7), rgen.star(9, 1),
                          rgen.clique(7, 2), rgen.chain(14, 3)]),
    "small8": (8, lambda: [rgen.chain(8, 1), rgen.cycle(7, 2),
                           rgen.star(6, 3), rgen.job_like(8, 4)]),
}
SIZES = [1, 127, 128, 129, 1000]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test, as in ``tests/test_torch_batch.py`` (this
    file imports nothing from ``tests`` so that it runs on the card)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_lanes(graphs, nmax: int, L: int, seed: int):
    """numpy lanes: sets inside each query's n bits, random sub/r, block a
    subset of S, (ub, vb) the endpoints of one of the query's edges."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((len(graphs), nmax), np.int32)
    for q, g in enumerate(graphs):
        for (u, v) in g.edges:
            adj[q, u] |= 1 << v
            adj[q, v] |= 1 << u
    qid = rng.integers(0, len(graphs), L).astype(np.int32)
    n_q = np.array([g.n for g in graphs])[qid]
    S = (rng.integers(1, 1 << 30, L) & ((1 << n_q) - 1)).astype(np.int32)
    edges = [np.array(g.edges) for g in graphs]
    uv = np.stack([edges[q][rng.integers(0, len(edges[q]))] for q in qid])
    lanes = {"S": S, "qid": qid,
             "sub": rng.integers(0, 1 << 16, L).astype(np.int32),
             "r": rng.integers(0, 1 << 16, L).astype(np.int32),
             "block": (S & rng.integers(0, 1 << 16, L)).astype(np.int32),
             "ub": (1 << uv[:, 0]).astype(np.int32),
             "vb": (1 << uv[:, 1]).astype(np.int32)}
    return lanes, adj


def port(g):
    return tjg.graph_from_wire(graph_to_wire(g))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("L", SIZES)
@pytest.mark.parametrize("name", list(KERNELS))
def test_plain_version_matches_reference(name, L, table):
    nmax, graphs = TABLES[table]
    lanes, adj = make_lanes(graphs(), nmax, L, seed=L + 7 * nmax)
    keys, jref, plain, _ = KERNELS[name]
    got = _as_tuple(plain(*[torch.from_numpy(lanes[k]) for k in keys],
                          torch.from_numpy(adj), nmax))
    want = _as_tuple(jref(*[jnp.asarray(lanes[k]) for k in keys],
                          jnp.asarray(adj), nmax))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", list(KERNELS))
def test_plain_version_matches_pallas_interpret(name):
    nmax, nb, L = 8, 4, 129
    lanes, adj = make_lanes(TABLES["small8"][1](), nmax, L, seed=11)
    keys, _, plain, pallas = KERNELS[name]
    got = _as_tuple(plain(*[torch.from_numpy(lanes[k]) for k in keys],
                          torch.from_numpy(adj), nmax))
    want = _as_tuple(pallas(*[jnp.asarray(lanes[k]) for k in keys],
                            jnp.asarray(adj), nmax=nmax, nb=nb,
                            interpret=True))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", list(KERNELS))
def test_wrapper_routes_cpu_tensors_to_plain_version(name):
    nmax = 8
    lanes, adj = make_lanes(TABLES["small8"][1](), nmax, 129, seed=3)
    keys, _, plain, _ = KERNELS[name]
    args = [torch.from_numpy(lanes[k]) for k in keys] + [torch.from_numpy(adj)]
    before = dict(ops.LAUNCHES)
    got = _as_tuple(getattr(ops, name)(*args, nmax))
    for a, b in zip(got, _as_tuple(plain(*args, nmax))):
        assert torch.equal(a, b)
    assert ops.LAUNCHES == before            # no kernel ran, none counted


def test_launch_checks_refuse_bad_inputs():
    S = torch.zeros(16, dtype=torch.int32)
    adj = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops._launch("bconnectivity", (S.long(), S), adj, 8, 1)
    with pytest.raises(ValueError, match="adj_b"):
        ops._launch("bconnectivity", (S, S), adj[:, :4], 8, 1)
    with pytest.raises(ValueError, match="int32"):
        ops._launch("bconnectivity", (S, S[:8]), adj, 8, 1)
    with pytest.raises(ValueError, match="devices"):
        ops.bconnectivity(S, S.to("meta"), adj, 8)


# ----------------------------------------------------------------- card --

@pytest.mark.gpu
@pytest.mark.parametrize("name", list(KERNELS))
def test_cuda_kernel_matches_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys, _, plain, _ = KERNELS[name]
    for table in TABLES:
        nmax, graphs = TABLES[table]
        for L in (1, 129, 32767, 32768):
            lanes, adj = make_lanes(graphs(), nmax, L, seed=L)
            args = [torch.from_numpy(lanes[k]).cuda() for k in keys]
            adj_d = torch.from_numpy(adj).cuda()
            n0 = ops.LAUNCHES[name]
            got = _as_tuple(getattr(ops, name)(*args, adj_d, nmax))
            assert ops.LAUNCHES[name] == n0 + 1
            want = _as_tuple(plain(*args, adj_d, nmax))
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.is_cuda and torch.equal(a, b), (name, table, L)


# ===================================================== solo-engine kernels ==
# One query's (nmax,) table shared by every lane.

SOLO_KERNELS = {
    "connectivity": (("S",), rref.connectivity_ref, tref.connectivity_ref,
                     rpallas.connectivity),
    "ccp_eval": (("S", "sub"), rref.ccp_eval_ref, tref.ccp_eval_ref,
                 rpallas.ccp_eval),
    "grow_pair": (("S", "lb", "rb"), rref.grow_pair_ref, tref.grow_pair_ref,
                  rpallas.grow_pair),
}
# the tests/test_kernels.py graphs that fit each bucket, plus small ones at
# nmax 8 and a 20-relation query at nmax 24
TK_GRAPHS = TABLES["tk16"][1]
SOLO_TABLES = {
    8: lambda: [rgen.clique(7, 2), rgen.chain(8, 1), rgen.cycle(7, 2)],
    16: TK_GRAPHS,
    24: lambda: TK_GRAPHS() + [rgen.musicbrainz_query(20, 11)],
}


def make_solo_lanes(g, nmax: int, L: int, seed: int):
    """numpy lanes over one query: S nonzero inside its n bits, sub any
    rank below 2^30, lb a subset of S and rb a subset of S & ~lb."""
    rng = np.random.default_rng(seed)
    adj = np.zeros(nmax, np.int32)
    for (u, v) in g.edges:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    S = (rng.integers(1, 1 << 30, L) & ((1 << g.n) - 1)).astype(np.int32)
    S[S == 0] = 1
    lb = (S & rng.integers(0, 1 << 30, L)).astype(np.int32)
    rb = (S & ~lb & rng.integers(0, 1 << 30, L)).astype(np.int32)
    lanes = {"S": S, "sub": rng.integers(0, 1 << 30, L).astype(np.int32),
             "lb": lb, "rb": rb}
    return lanes, adj


@pytest.mark.parametrize("nmax", list(SOLO_TABLES))
@pytest.mark.parametrize("L", SIZES)
@pytest.mark.parametrize("name", list(SOLO_KERNELS))
def test_solo_plain_version_matches_reference(name, L, nmax):
    # one graph per lane count, round robin: the sweep covers every graph
    graphs = SOLO_TABLES[nmax]()
    g = graphs[SIZES.index(L) % len(graphs)]
    keys, jref, plain, _ = SOLO_KERNELS[name]
    lanes, adj = make_solo_lanes(g, nmax, L, seed=L + 7 * nmax)
    got = _as_tuple(plain(*[torch.from_numpy(lanes[k]) for k in keys],
                          torch.from_numpy(adj), nmax))
    want = _as_tuple(jref(*[jnp.asarray(lanes[k]) for k in keys],
                          jnp.asarray(adj), nmax))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", list(SOLO_KERNELS))
def test_solo_plain_version_matches_pallas_interpret(name):
    nmax, L = 8, 129
    lanes, adj = make_solo_lanes(rgen.cycle(7, 2), nmax, L, seed=13)
    keys, _, plain, pallas = SOLO_KERNELS[name]
    got = _as_tuple(plain(*[torch.from_numpy(lanes[k]) for k in keys],
                          torch.from_numpy(adj), nmax))
    want = _as_tuple(pallas(*[jnp.asarray(lanes[k]) for k in keys],
                            jnp.asarray(adj), nmax=nmax, interpret=True))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", list(SOLO_KERNELS))
def test_solo_wrapper_routes_cpu_tensors_to_plain_version(name):
    nmax = 16
    lanes, adj = make_solo_lanes(rgen.star(9, 1), nmax, 129, seed=5)
    keys, _, plain, _ = SOLO_KERNELS[name]
    args = [torch.from_numpy(lanes[k]) for k in keys] + [torch.from_numpy(adj)]
    before = dict(ops.LAUNCHES)
    got = _as_tuple(getattr(ops, name)(*args, nmax))
    for a, b in zip(got, _as_tuple(plain(*args, nmax))):
        assert torch.equal(a, b)
    assert ops.LAUNCHES == before            # no kernel ran, none counted


def test_solo_launch_checks_refuse_bad_inputs():
    S = torch.zeros(16, dtype=torch.int32)
    adj = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="adj must be"):
        ops._launch("connectivity", (S,), adj[None, :], 8, 1)
    with pytest.raises(ValueError, match="adj must be"):
        ops._launch("ccp_eval", (S, S), adj, 16, 3)
    with pytest.raises(ValueError, match="int32"):
        ops._launch("grow_pair", (S, S.long(), S), adj, 8, 2)
    with pytest.raises(ValueError, match="unsupported"):
        ops._launch("connectivity", (S,), torch.zeros(31, dtype=torch.int32),
                    31, 1)
    with pytest.raises(ValueError, match="devices"):
        ops.grow_pair(S, S, S.to("meta"), adj, 8)


# ----------------------------------------------------------------- card --

SOLO_GPU_TABLES = {8: lambda: [rgen.cycle(7, 2)],
                   16: lambda: [rgen.musicbrainz_query(12, 7)],
                   24: lambda: [rgen.musicbrainz_query(20, 11)],
                   30: lambda: [rgen.chain(25, 1), rgen.musicbrainz_query(26, 3)]}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SOLO_KERNELS) + ["btree_eval_one_row"])
def test_cuda_solo_kernel_matches_plain_version(name):
    """The solo kernels, and ``btree_eval`` on the one-row table the solo
    tree evaluate gives it, at every solo bucket up to nmax 30."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for nmax, graphs in SOLO_GPU_TABLES.items():
        for g in graphs():
            for L in (1, 129, 32767, 32768):
                lanes, adj = make_solo_lanes(g, nmax, L, seed=L + nmax)
                adj_d = torch.from_numpy(adj).cuda()
                if name == "btree_eval_one_row":
                    uv = np.array(g.edges)[np.arange(L) % g.m]
                    args = [torch.from_numpy(x).cuda() for x in (
                        lanes["S"], (1 << uv[:, 0]).astype(np.int32),
                        (1 << uv[:, 1]).astype(np.int32),
                        np.zeros(L, np.int32))]
                    fn, plain, key = ops.btree_eval, tref.btree_eval_ref, "btree_eval"
                    adj_d = adj_d[None, :].contiguous()
                else:
                    keys, _, plain, _ = SOLO_KERNELS[name]
                    args = [torch.from_numpy(lanes[k]).cuda() for k in keys]
                    fn, key = getattr(ops, name), name
                n0 = ops.LAUNCHES[key]
                got = _as_tuple(fn(*args, adj_d, nmax))
                assert ops.LAUNCHES[key] == n0 + 1
                want = _as_tuple(plain(*args, adj_d, nmax))
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert a.is_cuda and torch.equal(a, b), (name, nmax, g.n, L)


# ================================================ lanes built in the kernel ==
# connectivity_span: the filter of one level span; ccp_eval_dpsub: a DPSUB
# chunk decoded from the level's set list.

RCHUNK = 32768                         # the reference filter's chunk
SPAN_GRAPHS = [(nmax, j) for nmax in (8, 16, 24)
               for j in range(len(SOLO_TABLES[nmax]()))] + [(30, 0)]


def span_graph(nmax: int, j: int):
    return rgen.chain(25, 1) if nmax == 30 else SOLO_TABLES[nmax]()[j]


def adj_of(g, nmax: int) -> np.ndarray:
    adj = np.zeros(nmax, np.int32)
    for (u, v) in g.edges:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    return adj


def spans_of(total: int):
    """Spans that start mid-chunk, cross chunk boundaries (where the level
    is large enough), end ragged inside the level or at its end."""
    out = [(total // 3, total - total // 3 - total // 5), (0, total)]
    if total > 2 * RCHUNK:
        out = [(RCHUNK - 7, RCHUNK + 20),             # crosses two boundaries
               (3 * RCHUNK + 1234, 2 * RCHUNK + 77),
               (total - RCHUNK - 5, RCHUNK + 5)]      # ends at the level's end
    return [(r0, c) for r0, c in out if c > 0]


def reference_filter(k, rank0, count, total, adj, nmax):
    """The reference's (S, conn) for ranks rank0 .. rank0 + count - 1: its
    32768-rank chunks, concatenated, masked lanes (rank >= total) dropped."""
    first = rank0 // RCHUNK * RCHUNK
    binom = jnp.asarray(rur.binom_table(nmax))
    S_l, conn_l = [], []
    for c0 in range(first, rank0 + count, RCHUNK):
        S, conn = reng._filter_chunk(c0, total, k, binom, jnp.asarray(adj),
                                     nmax=nmax, chunk=RCHUNK)
        live = c0 + np.arange(RCHUNK) < total
        S_l.append(np.asarray(S)[live])
        conn_l.append(np.asarray(conn)[live])
    lo = rank0 - first
    return (np.concatenate(S_l)[lo: lo + count],
            np.concatenate(conn_l)[lo: lo + count].astype(np.int32))


@pytest.mark.parametrize("nmax,j", SPAN_GRAPHS,
                         ids=[f"nmax{n}-g{j}" for n, j in SPAN_GRAPHS])
def test_connectivity_span_matches_reference_filter(nmax, j):
    g = span_graph(nmax, j)
    adj = adj_of(g, nmax)
    binom = torch.from_numpy(tur.binom_table(nmax))
    for k in sorted({1, g.n // 2, g.n}):
        total = comb(g.n, k)
        for rank0, count in spans_of(total):
            S, conn = tref.connectivity_span_ref(k, rank0, count, binom,
                                                 torch.from_numpy(adj), nmax)
            want_S, want_conn = reference_filter(k, rank0, count, total,
                                                 adj, nmax)
            assert S.dtype == conn.dtype == torch.int32
            np.testing.assert_array_equal(S.numpy(), want_S, err_msg=(k, rank0))
            np.testing.assert_array_equal(conn.numpy(), want_conn,
                                          err_msg=(k, rank0))


def reference_dpsub(all_sets, level_off, base_set, base_sub, i, adj, nmax,
                    chunk):
    """The reference's DPSUB decode, pdep and ccp test
    (``repro.core.engine._eval_dpsub_chunk``), every lane of the chunk."""
    t = jnp.arange(chunk, dtype=jnp.int32)
    sub_g = base_sub + t
    set_idx = base_set + (sub_g >> i)
    sub = sub_g & ((jnp.int32(1) << i) - 1)
    S = all_sets[level_off + set_idx]
    lb = rbs.pdep(sub, S, nmax)
    rb = S & ~lb
    nonempty = (lb != 0) & (rb != 0)
    conn_l = rbs.is_connected(lb, adj)
    conn_r = rbs.is_connected(rb, adj)
    cross = (rbs.neighbors(lb, adj) & rb) != 0
    return lb, rb, nonempty & conn_l & conn_r & cross


def make_dpsub_case(g, nmax: int, i: int, chunk: int, seed: int):
    """A level of 257 sets inside the query's n bits at a random offset; the
    chunk starts at a random (set, subset) so that its lanes run past the
    level's end (dead lanes, then the clamped gather) where it is long
    enough."""
    rng = np.random.default_rng(seed)
    all_sets = rng.integers(1, 1 << g.n, 257).astype(np.int32)
    level_off = int(rng.integers(0, 100))
    base_set = int(rng.integers(0, 100))
    base_sub = int(rng.integers(0, 1 << i))
    return all_sets, (level_off, base_set, base_sub, i), adj_of(g, nmax)


DPSUB_CASES = [(nmax, i, chunk) for nmax in (8, 16, 24, 30)
               for i in (2, 5, 7) for chunk in (1, 129, 4096)]


@pytest.mark.parametrize("nmax,i,chunk", DPSUB_CASES)
def test_ccp_eval_dpsub_matches_reference_decode(nmax, i, chunk):
    g = span_graph(nmax, 0 if nmax == 30 else i % len(SOLO_TABLES[nmax]()))
    all_sets, dec, adj = make_dpsub_case(g, nmax, i, chunk,
                                         seed=nmax * 100 + i * 10 + chunk)
    got = tref.ccp_eval_dpsub_ref(torch.from_numpy(all_sets), *dec,
                                  torch.from_numpy(adj), nmax, chunk)
    want = reference_dpsub(jnp.asarray(all_sets), *dec, jnp.asarray(adj),
                           nmax, chunk)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and a.shape == (chunk,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int32))


def span_args(nmax=16, k=5, rank0=10, count=300, g=None):
    g = g or rgen.star(9, 1)
    return (k, rank0, count, torch.from_numpy(tur.binom_table(nmax)),
            torch.from_numpy(adj_of(g, nmax)), nmax)


def dpsub_args(nmax=16, i=5, chunk=300):
    all_sets, dec, adj = make_dpsub_case(rgen.star(9, 1), nmax, i, chunk, 9)
    return (torch.from_numpy(all_sets), *dec, torch.from_numpy(adj), nmax,
            chunk)


@pytest.mark.parametrize("name", ["connectivity_span", "ccp_eval_dpsub"])
def test_lane_building_wrapper_routes_cpu_tensors_to_plain_version(name):
    args = span_args() if name == "connectivity_span" else dpsub_args()
    before = dict(ops.LAUNCHES)
    got = getattr(ops, name)(*args)
    for a, b in zip(got, getattr(tref, f"{name}_ref")(*args)):
        assert torch.equal(a, b)
    assert ops.LAUNCHES == before            # no kernel ran, none counted


def test_span_launch_checks_refuse_bad_inputs():
    k, rank0, count, binom, adj, nmax = span_args()
    with pytest.raises(ValueError, match="adj must be"):
        ops._launch_span(k, rank0, count, binom, adj.long(), nmax)
    with pytest.raises(ValueError, match="binom must be"):
        ops._launch_span(k, rank0, count, binom[:, :4], adj, nmax)
    with pytest.raises(ValueError, match="unsupported"):
        ops._launch_span(k, rank0, count, torch.zeros((32, 32), dtype=torch.int32),
                         torch.zeros(31, dtype=torch.int32), 31)
    with pytest.raises(ValueError, match="count"):
        ops._launch_span(k, rank0, -1, binom, adj, nmax)
    with pytest.raises(ValueError, match="span_end"):
        ops._launch_span(k, (1 << 31) - 5, 10, binom, adj, nmax)
    with pytest.raises(ValueError, match="k = 17"):
        ops._launch_span(17, rank0, count, binom, adj, nmax)
    with pytest.raises(ValueError, match="devices"):
        ops.connectivity_span(k, rank0, count, binom.to("meta"), adj, nmax)


def test_dpsub_launch_checks_refuse_bad_inputs():
    all_sets, level_off, base_set, base_sub, i, adj, nmax, chunk = dpsub_args()
    with pytest.raises(ValueError, match="all_sets must be"):
        ops._launch_dpsub(all_sets.long(), level_off, base_set, base_sub, i,
                          adj, nmax, chunk)
    with pytest.raises(ValueError, match="all_sets must be"):
        ops._launch_dpsub(all_sets[:0], level_off, base_set, base_sub, i,
                          adj, nmax, chunk)
    with pytest.raises(ValueError, match="unsupported"):
        ops._launch_dpsub(all_sets, level_off, base_set, base_sub, i,
                          torch.zeros(0, dtype=torch.int32), 0, chunk)
    with pytest.raises(ValueError, match="chunk"):
        ops._launch_dpsub(all_sets, level_off, base_set, base_sub, i, adj,
                          nmax, -1)
    with pytest.raises(ValueError, match="i = 31"):
        ops._launch_dpsub(all_sets, level_off, base_set, base_sub, 31, adj,
                          nmax, chunk)
    with pytest.raises(ValueError, match="base_sub"):
        ops._launch_dpsub(all_sets, level_off, base_set, 1 << 31, i, adj,
                          nmax, chunk)
    with pytest.raises(ValueError, match="devices"):
        ops.ccp_eval_dpsub(all_sets.to("meta"), level_off, base_set, base_sub,
                           i, adj, nmax, chunk)


# ----------------------------------------------------------------- card --

@pytest.mark.gpu
def test_cuda_connectivity_span_matches_plain_version():
    """Spans of 1, 129, 32767 and 32768 ranks and a whole level, at every
    solo bucket up to nmax 30 (chain(25)'s level 12 is the filter's
    largest span on the main path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for nmax, graphs in SOLO_GPU_TABLES.items():
        for g in graphs():
            k = g.n // 2
            total = comb(g.n, k)
            binom = torch.from_numpy(tur.binom_table(nmax)).cuda()
            adj = torch.from_numpy(adj_of(g, nmax)).cuda()
            for count in (1, 129, 32767, 32768, total):
                rank0 = max(0, total - count) // 2
                n0 = ops.LAUNCHES["connectivity_span"]
                got = ops.connectivity_span(k, rank0, count, binom, adj, nmax)
                assert ops.LAUNCHES["connectivity_span"] == n0 + 1
                want = tref.connectivity_span_ref(k, rank0, count, binom, adj,
                                                  nmax)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert a.is_cuda and torch.equal(a, b), (nmax, g.n, count)


@pytest.mark.gpu
def test_cuda_ccp_eval_dpsub_matches_plain_version():
    """Chunks of 1, 129, 32767 and 32768 lanes at every solo bucket up to
    nmax 30, with dead and clamped lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for nmax, graphs in SOLO_GPU_TABLES.items():
        for g in graphs():
            for i in (2, 5, min(g.n, 12)):
                for chunk in (1, 129, 32767, 32768):
                    all_sets, dec, adj = make_dpsub_case(g, nmax, i, chunk,
                                                         seed=chunk + i)
                    args = (torch.from_numpy(all_sets).cuda(), *dec,
                            torch.from_numpy(adj).cuda(), nmax, chunk)
                    n0 = ops.LAUNCHES["ccp_eval_dpsub"]
                    got = ops.ccp_eval_dpsub(*args)
                    assert ops.LAUNCHES["ccp_eval_dpsub"] == n0 + 1
                    want = tref.ccp_eval_dpsub_ref(*args)
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        assert a.is_cuda and torch.equal(a, b), (nmax, i, chunk)


# ======================================== batched forms: lanes in the kernel ==
# bconnectivity_span: the batched filter of one level; btree_eval_decode: an
# MPDP:Tree chunk decoded from its offset tables (batched, or one-row solo).

BCHUNK = 4096                          # reference filter chunk in these tests
BATCHES = {
    8: lambda: [rgen.chain(8, 1), rgen.cycle(7, 2), rgen.star(6, 3),
                rgen.job_like(8, 4)],
    16: lambda: rgen.mixed_stream(5, seed=0, sizes=(12, 13, 14, 15, 16)),
}
TREE_BATCHES = {
    8: lambda: [rgen.chain(8, 1), rgen.star(6, 3), rgen.snowflake(8, 2)],
    16: lambda: [rgen.chain(12, 2), rgen.star(10, 1), rgen.snowflake(13, 3),
                 rgen.chain(16, 4), rgen.star(9, 5)],
}


def adj_stack(graphs, bcap: int, nmax: int) -> np.ndarray:
    adj = np.zeros((bcap, nmax), np.int32)
    for q, g in enumerate(graphs):
        adj[q] = adj_of(g, nmax)
    return adj


def level_prefix(graphs, k: int, bcap: int):
    """(global int32[bcap+1] rank prefix of C(n_q, k), padded; int64
    prefix over the B queries)."""
    foff = np.zeros(len(graphs) + 1, np.int64)
    np.cumsum([comb(g.n, k) for g in graphs], out=foff[1:])
    fpad = np.full(bcap + 1, foff[-1], np.int64)
    fpad[: len(foff)] = foff
    return fpad.astype(np.int32), foff


@pytest.mark.parametrize("nmax", list(BATCHES))
def test_bconnectivity_span_matches_reference_filter(nmax):
    graphs = BATCHES[nmax]()
    B = len(graphs)
    bcap = rbatch._bcap(B)
    adj = adj_stack(graphs, bcap, nmax)
    binom = rur.binom_table(nmax)
    chunk = jax.jit(partial(rbatch._bfilter_chunk, nmax=nmax, chunk=BCHUNK,
                            bcap=bcap, pallas=False))
    eng = tbatch.BatchEngine([port(g) for g in graphs], algorithm="dpsub",
                             device="cpu")
    np.testing.assert_array_equal(eng.adj_b.numpy(), adj)
    for k in range(1, max(g.n for g in graphs) + 1):
        fpad, foff = level_prefix(graphs, k, bcap)
        total = int(foff[-1])
        want = [[], [], []]
        for lane0 in range(0, total, BCHUNK):
            fl = np.clip(foff - lane0, -(1 << 30), 1 << 30)
            fc = np.full(bcap + 1, fl[B], np.int32)
            fc[: B + 1] = fl
            live = lane0 + np.arange(BCHUNK) < total
            for acc, x in zip(want, chunk(jnp.asarray(fc), k,
                                          jnp.asarray(binom),
                                          jnp.asarray(adj))):
                acc.append(np.asarray(x)[live])
        want_S, want_conn, want_qid = (np.concatenate(w) for w in want)
        got = tref.bconnectivity_span_ref(k, torch.from_numpy(fpad), total,
                                          torch.from_numpy(binom),
                                          torch.from_numpy(adj), nmax)
        for a, b in zip(got, (want_S, want_conn.astype(np.int32), want_qid)):
            assert a.dtype == torch.int32 and a.shape == (total,)
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"k={k}")
        # the port's filter: one span a level, compacted and split per query
        per_q = eng._filter_collect(eng._filter_dispatch(k))
        for q in range(B):
            np.testing.assert_array_equal(
                per_q[q], want_S[want_conn & (want_qid == q)],
                err_msg=f"k={k} q={q}")


def make_tree_case(graphs, nmax: int, chunk: int, seed: int):
    """btree_eval_decode arguments as ``BatchEngine._eval_dispatch`` lays
    them out: per-query set lists (sets inside the query's n bits) packed
    back to back in ``all_sets`` (so a lane past a list reads its
    neighbour's, and the last one clamps), edge tables padded to emax, the
    chunk at a random lane of the level: where the chunk is long enough its
    lanes run past the level's end (dead lanes, the padding queries, the
    clamped gather)."""
    rng = np.random.default_rng(seed)
    B = len(graphs)
    bcap = rbatch._bcap(B)
    emax = max(8, -(-max(g.m for g in graphs) // 8) * 8)
    m = np.zeros(bcap, np.int32)
    emu = np.zeros((bcap, emax), np.int32)
    emv = np.zeros((bcap, emax), np.int32)
    for q, g in enumerate(graphs):
        m[q] = g.m
        for j, (u, v) in enumerate(g.edges):
            emu[q, j], emv[q, j] = 1 << u, 1 << v
    ns = rng.integers(1, 200, B)
    all_sets = np.concatenate([rng.integers(1, 1 << g.n, c) for g, c
                               in zip(graphs, ns)]).astype(np.int32)
    soff = np.zeros(B + 1, np.int64)
    np.cumsum(ns, out=soff[1:])
    loff = np.zeros(bcap, np.int32)
    loff[:B] = soff[:B]
    spad = np.full(bcap, soff[B], np.int32)
    spad[:B] = soff[:B]
    eoff = np.zeros(B + 1, np.int64)
    np.cumsum(ns * m[:B], out=eoff[1:])
    lane0 = int(rng.integers(0, eoff[-1]))
    el = eoff - lane0
    epad = np.full(bcap + 1, el[B], np.int32)
    epad[: B + 1] = el
    p0 = min(max(int(np.searchsorted(eoff, lane0, side="right")) - 1, 0), B - 1)
    seg0 = int(soff[p0] + (lane0 - eoff[p0]) // m[p0])
    return (all_sets, epad, loff, spad, seg0, m, emu, emv,
            adj_stack(graphs, bcap, nmax), nmax, chunk + 2, chunk)


def reference_tree_decode(all_sets, eoff, loff, soff, seg0, m_b, emu_b, emv_b,
                          adj_b, nmax, nseg, chunk):
    """The reference's MPDP:Tree lane decode and split
    (``repro.core.batch._beval_tree_chunk``, ``pallas=False``), every lane
    of the chunk."""
    bcap = adj_b.shape[0]
    t = jnp.arange(chunk, dtype=jnp.int32)
    qid = jnp.clip(jnp.searchsorted(eoff, t, side="right").astype(jnp.int32)
                   - 1, 0, bcap - 1)
    local = t - eoff[qid]
    live = t < eoff[bcap]
    mq = jnp.maximum(m_b[qid], 1)
    set_idx = local // mq
    e = local % mq
    S = all_sets[loff[qid] + set_idx]
    ub = emu_b[qid, e]
    vb = emv_b[qid, e]
    edge_in = live & ((S & ub) != 0) & ((S & vb) != 0)
    S_left = rbs.grow_excl_edge_rows(ub, S, adj_b[qid], ub, vb)
    seg = jnp.clip(soff[qid] + set_idx - seg0, 0, nseg - 1)
    return S, S_left, edge_in, qid, seg


TREE_DECODE_CASES = [(8, 129), (8, 4096), (16, 1), (16, 4096)]


@pytest.mark.parametrize("nmax,chunk", TREE_DECODE_CASES)
def test_btree_eval_decode_matches_reference_decode(nmax, chunk):
    args = make_tree_case(BATCHES[nmax](), nmax, chunk, seed=nmax + chunk)
    conv = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]
    got = tref.btree_eval_decode_ref(*conv)
    want = reference_tree_decode(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                   else a for a in args])
    if chunk == 4096:      # the case reaches dead lanes and the clamp
        q = got[3].numpy()
        local = np.arange(chunk) - args[1][q]
        idx = args[2][q] + local // np.maximum(args[5][q], 1)
        assert args[1][-1] < chunk and idx.max() >= len(args[0])
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and a.shape == (chunk,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int32))


class PruneLanes:
    """Records the lanes ``(seg, cand, left)`` of the last ``_prune`` call
    of the port's chunk bodies, so that a test can show a tie."""

    def __init__(self, mp):
        self.last = None
        for m in (tchunks, teng):
            mp.setattr(m, "_prune", self._recording(m._prune))

    def _recording(self, real):
        def prune(seg, cand, left, nseg):
            self.last = tuple(x.numpy() for x in (seg, cand, left))
            return real(seg, cand, left, nseg)
        return prune


def _own_buffer(real, args, kw):
    """A chunk body's call as a held test compares it: ``(got, launched)``
    with ``got`` its result into its own buffer (``chunks._fetch`` reads
    it) and ``launched()`` the call as the engine made it, into the device
    fold's ``keys``/``counts`` where it gave them."""
    targets = {k: kw.pop(k) for k in ("keys", "counts") if k in kw}
    got = real(*args, **kw)
    return got, (lambda: real(*args, **kw, **targets) if targets else got)


def _hold_chunk(got, want, label, lanes=None, ties=None):
    """A chunk body's result, read back as the level loops read it
    (``chunks._fetch``: a fused chunk's ``Pruned`` buffer or the torch
    epilogue's four tensors), against the reference's (seg_cost, seg_left,
    ev, ccp): integers exact, costs within a
    relative 1e-5; returns the largest ULP distance of the costs.  Given
    the port's pruned ``lanes`` (``PruneLanes.last``), a segment may keep
    another left bitmap than the reference only in a tie broken by
    rounding: the reference's left is one of the port's own candidates of
    the segment, at a cost within 1e-5 of the port's minimum (counted in
    ``ties``)."""
    sc, sl, ev, cc = (np.asarray(x).reshape(-1) for x in tchunks._fetch(got))
    wsc, wsl, wev, wcc = (np.asarray(x).reshape(-1) for x in want)
    for a, b in ((ev, wev), (cc, wcc)):
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=label)
    fin = np.isfinite(wsc)
    np.testing.assert_array_equal(np.isfinite(sc), fin, err_msg=label)
    np.testing.assert_allclose(sc[fin], wsc[fin], rtol=1e-5, err_msg=label)
    off = np.flatnonzero(sl != wsl)
    if lanes is None or not len(off):
        np.testing.assert_array_equal(sl, wsl.astype(sl.dtype), err_msg=label)
    for k in off:
        seg, cand, left = lanes
        mine = (seg == k) & (left == wsl[k]) & np.isfinite(cand)
        assert mine.any() and cand[mine].min() <= sc[k] * (1 + 1e-5), \
            f"{label}: segment {k} keeps {sl[k]} for the reference's {wsl[k]}"
        if ties is not None:
            ties.append((label, int(k)))
    return int(np.abs(sc[fin].view(np.int32).astype(np.int64)
                      - wsc[fin].view(np.int32).astype(np.int64)).max(initial=0))


@pytest.mark.parametrize("nmax", list(TREE_BATCHES))
def test_beval_tree_chunk_matches_reference(nmax, monkeypatch):
    """Every chunk of a batched MPDP:Tree run on the CPU, held against the
    reference's chunk body on the same arguments and memo."""
    graphs = TREE_BATCHES[nmax]()
    chunk = 64 if nmax == 8 else 1024
    bcap = rbatch._bcap(len(graphs))
    want_fn = jax.jit(partial(rbatch._beval_tree_chunk, nmax=nmax, chunk=chunk,
                              nseg=chunk + 2, bcap=bcap, pallas=False))
    real = tchunks._beval_tree_chunk
    worst = [0, 0]

    def held(*args, **kw):
        got, launched = _own_buffer(real, args, kw)
        want = want_fn(*[jnp.asarray(a.numpy()) if torch.is_tensor(a) else a
                         for a in args])
        worst[0] = max(worst[0], _hold_chunk(got, want, f"call {worst[1]}"))
        worst[1] += 1
        return launched()

    monkeypatch.setattr(tchunks, "_beval_tree_chunk", held)
    tbatch.BatchEngine([port(g) for g in graphs], chunk=chunk,
                       algorithm="mpdp_tree", device="cpu").run()
    assert worst[1] > max(g.n for g in graphs)      # several chunks a level
    print(f"nmax={nmax}: {worst[1]} chunks, largest cost difference "
          f"{worst[0]} ulp")


@pytest.mark.parametrize("g", [rgen.chain(8, 3), rgen.snowflake(13, 2)],
                         ids=["chain8", "snowflake13"])
def test_eval_tree_chunk_matches_reference(g, monkeypatch):
    """Every chunk of a solo MPDP:Tree run on the CPU (the chunk layer's
    body at bcap 1 on one-row tables), held against the reference's
    ``_eval_tree_chunk`` on the same memo."""
    chunk = 512
    real = tchunks._beval_tree_chunk
    worst = [0, 0]

    def held(all_sets, eoff, loff, soff, seg0, m1, adj1, emu1, emv1,
             memo_cost, memo_rows, **kw):
        got, launched = _own_buffer(real, (all_sets, eoff, loff, soff, seg0,
                                           m1, adj1, emu1, emv1, memo_cost,
                                           memo_rows), kw)
        assert (kw["bcap"], seg0, int(soff[0])) == (1, 0, 0)
        j = [jnp.asarray(a.numpy()) for a in
             (all_sets, adj1[0], emu1[0], emv1[0], memo_cost, memo_rows)]
        want = reng._eval_tree_chunk(
            j[0], jnp.int32(int(loff[0])), jnp.int32(0),
            jnp.int32(-int(eoff[0])), jnp.int32(int(m1[0])),
            jnp.int32(int(eoff[1])), *j[1:], nmax=kw["nmax"],
            chunk=kw["chunk"], nseg=kw["nseg"])
        worst[0] = max(worst[0], _hold_chunk(
            got, [want[0], want[1], np.asarray(want[2]).reshape(()),
                  np.asarray(want[3]).reshape(())], f"call {worst[1]}"))
        worst[1] += 1
        return launched()

    monkeypatch.setattr(tchunks, "_beval_tree_chunk", held)
    teng.optimize(port(g), "mpdp_tree", chunk=chunk, device="cpu")
    assert worst[1] >= g.n - 1
    print(f"n={g.n}: {worst[1]} chunks, largest cost difference {worst[0]} ulp")


def old_solo_tree_decode(all_sets, level_off, base_set, base_e, m,
                         lane_count, adj, emask_u, emask_v, nmax, chunk):
    """The solo tree decode the one-row tables replaced: (S, S_left,
    edge_in, segment) of ``base_e + t`` over ``sets x m`` from set
    ``level_off + base_set``."""
    t = torch.arange(chunk, dtype=torch.int32)
    e_g = base_e + t
    set_idx = base_set + torch.div(e_g, m, rounding_mode="floor")
    e = torch.remainder(e_g, m)
    S = all_sets[(level_off + set_idx).clamp(0, all_sets.shape[0] - 1)]
    S_left, in_i = tref.btree_eval_ref(S, emask_u[e], emask_v[e],
                                       torch.zeros_like(t), adj[None], nmax)
    return S, S_left, ((t < lane_count) & (in_i != 0)).to(torch.int32), \
        set_idx - base_set


SOLO_TREE_CASES = [(nmax, chunk, seed) for nmax in (8, 16, 24, 30)
                   for chunk, seed in ((1, 1), (129, 2), (4096, 3))]


@pytest.mark.parametrize("nmax,chunk,seed", SOLO_TREE_CASES)
def test_solo_tree_offsets_match_the_old_decode(nmax, chunk, seed):
    g = span_graph(nmax, 0 if nmax == 30 else seed % len(SOLO_TABLES[nmax]()))
    dg = teng.DeviceGraph.from_graph(g, "cpu")
    rng = np.random.default_rng(nmax * 10 + seed)
    all_sets = torch.from_numpy(rng.integers(1, 1 << g.n, 3000).astype(np.int32))
    level_off, base_set = int(rng.integers(0, 1000)), int(rng.integers(0, 1000))
    base_e = int(rng.integers(0, g.m))
    lane_count = int(rng.integers(0, chunk + 1))
    offs = torch.from_numpy(teng._tree_offsets(level_off, base_set, base_e,
                                               lane_count))
    S, S_left, edge_in, qid, seg = tref.btree_eval_decode_ref(
        all_sets, offs[0:2], offs[2:3], offs[3:4], 0,
        torch.tensor([g.m], dtype=torch.int32), dg.emask_u[None],
        dg.emask_v[None], dg.adj[None], nmax, chunk + 1, chunk)
    want = old_solo_tree_decode(all_sets, level_off, base_set, base_e, g.m,
                                lane_count, dg.adj, dg.emask_u, dg.emask_v,
                                nmax, chunk)
    for a, b in zip((S, S_left, edge_in, seg), want):
        assert torch.equal(a, b)
    assert not qid.any()


# ================================================= MPDP-general decode ==
# bgeneral_eval_decode: a chunk's (pair, rank) lanes decoded from its pair
# table; the batched engine on the stacked table, the solo one on one row.

GENERAL_BATCHES = {
    8: lambda: [rgen.cycle(7, 2), rgen.clique(6, 1), rgen.cycle(8, 3),
                rgen.job_like(8, 4)],
    16: lambda: [rgen.cycle(13, 1), rgen.clique(9, 2), rgen.cycle(16, 3),
                 rgen.job_like(14, 4)],
}


def random_pairs(ns, rng):
    """Per query (n relations each in ``ns``) up to 600 (set, block) pairs
    sorted by set: sets inside the query's n bits, blocks subsets of them
    with at least two members; -> (set, block, query) arrays, concatenated
    in query order."""
    ps, pb, pq = [], [], []
    for q, n in enumerate(ns):
        S = rng.integers(1, 1 << n, 4000)
        blk = S & rng.integers(1, 1 << n, 4000)
        keep = np.flatnonzero(rbs.np_popcount(blk) >= 2)[: rng.integers(1, 600)]
        order = np.argsort(S[keep], kind="stable")
        ps.append(S[keep][order])
        pb.append(blk[keep][order])
        pq.append(np.full(len(keep), q))
    return (np.concatenate(ps).astype(np.int32),
            np.concatenate(pb).astype(np.int32),
            np.concatenate(pq).astype(np.int32))


def make_general_case(ns, adj_b, nmax: int, chunk: int, seed: int,
                      clamp: bool = False, tail: bool = False):
    """bgeneral_eval_decode arguments as the engines' general dispatch lays
    them out (``chunks._pair_table``): random pairs of queries with ``ns``
    relations, the chunk at a random lane of the level (``tail``: in the
    level's last half chunk, so that its lanes run past the level's end:
    dead lanes, whose ranks run past their block).  ``clamp``: the offsets
    shifted up (lanes below the first pair: p clamps to 0, r is negative)
    and ``n_pairs`` cut to half the pairs that start inside the chunk (p
    clamps to n_pairs - 1)."""
    rng = np.random.default_rng(seed)
    ps, pb, pq = random_pairs(ns, rng)
    offs = np.zeros(len(ps) + 1, np.int64)
    np.cumsum(np.int64(1) << rbs.np_popcount(pb).astype(np.int64), out=offs[1:])
    lane0 = int(rng.integers(max(0, offs[-1] - chunk // 2) if tail else 0,
                             offs[-1]))
    lane1 = min(lane0 + chunk, int(offs[-1]))
    p0 = int(np.searchsorted(offs, lane0, side="right")) - 1
    p1 = int(np.searchsorted(offs, lane1, side="left"))
    pairs = tchunks._pair_table(ps, pb, pq, offs, p0, p1, lane0)
    n_pairs = p1 - p0
    if clamp:
        pairs[3, :n_pairs] += np.int32(rng.integers(1, chunk // 2 + 2))
        n_pairs = max(1, int((pairs[3, :n_pairs] < chunk).sum()) // 2)
    return pairs, n_pairs, lane1 - lane0, adj_b, nmax, chunk


def general_batch_case(nmax: int, chunk: int, seed: int, clamp=False,
                       tail=False):
    graphs = GENERAL_BATCHES[nmax]()
    return make_general_case([g.n for g in graphs],
                             adj_stack(graphs, rbatch._bcap(len(graphs)), nmax),
                             nmax, chunk, seed, clamp, tail)


def general_solo_case(g, nmax: int, chunk: int, seed: int, clamp=False,
                      tail=False):
    return make_general_case([g.n], adj_of(g, nmax)[None], nmax, chunk, seed,
                             clamp, tail)


def reference_general_decode(pairs, n_pairs, lane_count, adj_b, nmax, chunk):
    """The reference's batched MPDP-general lane decode and split
    (``repro.core.batch._beval_general_chunk``, ``pallas=False``), every
    lane of the chunk."""
    pair_set, pair_block, pair_qid, off_local = (jnp.asarray(x) for x in pairs)
    t = jnp.arange(chunk, dtype=jnp.int32)
    live = t < lane_count
    p = jnp.clip(jnp.searchsorted(off_local, t, side="right").astype(jnp.int32)
                 - 1, 0, n_pairs - 1)
    r = t - off_local[p]
    S = pair_set[p]
    block = pair_block[p]
    qid = pair_qid[p]
    adjq = jnp.asarray(adj_b)[qid]
    lb = rbs.pdep(r, block, nmax)
    rb = block & ~lb
    enum_ok = live & (lb != 0) & (rb != 0)
    conn_l = rbs.is_connected_rows(lb, adjq)
    conn_r = rbs.is_connected_rows(rb, adjq)
    cross = (rbs.neighbors_rows(lb, adjq) & rb) != 0
    ccp_blk = enum_ok & conn_l & conn_r & cross
    S_left = rbs.grow_rows(lb, S & ~rb, adjq)
    return S, S_left, enum_ok, ccp_blk, qid, p


def reference_solo_general_decode(pairs, n_pairs, lane_count, adj, nmax,
                                  chunk):
    """The reference's solo MPDP-general lane decode and split
    (``repro.core.engine._eval_general_chunk``) on one table: (S, S_left,
    enum_ok, ccp, p)."""
    pair_set, pair_block, _, off_local = (jnp.asarray(x) for x in pairs)
    adj = jnp.asarray(adj)
    t = jnp.arange(chunk, dtype=jnp.int32)
    live = t < lane_count
    p = jnp.searchsorted(off_local, t, side="right").astype(jnp.int32) - 1
    p = jnp.clip(p, 0, n_pairs - 1)
    r = t - off_local[p]
    S = pair_set[p]
    block = pair_block[p]
    lb = rbs.pdep(r, block, nmax)
    rb = block & ~lb
    enum_ok = live & (lb != 0) & (rb != 0)
    conn_l = rbs.is_connected(lb, adj)
    conn_r = rbs.is_connected(rb, adj)
    cross = (rbs.neighbors(lb, adj) & rb) != 0
    ccp_blk = enum_ok & conn_l & conn_r & cross
    S_left = rbs.grow(lb, S & ~rb, adj)
    return S, S_left, enum_ok, ccp_blk, p


def _as_torch(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _dead_lanes_past_their_block(args, got) -> bool:
    pairs, n_pairs, lane_count, _, _, chunk = args
    p = got[5].numpy()
    r = np.arange(chunk) - pairs[3][p]
    past = r >= (1 << rbs.np_popcount(pairs[1][p]))
    return lane_count < chunk and past[lane_count:].all()


GENERAL_DECODE_CASES = [(nmax, chunk, clamp) for nmax in (8, 16)
                        for chunk in (1, 129, 4096) for clamp in (False, True)]


@pytest.mark.parametrize("nmax,chunk,clamp", GENERAL_DECODE_CASES)
def test_bgeneral_eval_decode_matches_reference_decode(nmax, chunk, clamp):
    args = general_batch_case(nmax, chunk, seed=nmax + chunk, clamp=clamp,
                              tail=chunk == 4096)
    got = tref.bgeneral_eval_decode_ref(*_as_torch(args))
    want = reference_general_decode(*args)
    if chunk == 4096 and not clamp:
        assert _dead_lanes_past_their_block(args, got)
    if clamp and chunk > 1:       # the clamps of p are reached
        ub = np.searchsorted(args[0][3], np.arange(chunk), side="right")
        assert (ub == 0).any() and (chunk < 4096 or (ub > args[1]).any())
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and a.shape == (chunk,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int32))


GENERAL_SOLO_CASES = [(nmax, chunk, clamp) for nmax in (24, 30)
                      for chunk in (1, 129, 4096) for clamp in (False, True)]
GENERAL_SOLO_GRAPHS = {24: lambda: rgen.musicbrainz_query(20, 11),
                       30: lambda: rgen.musicbrainz_query(26, 3)}


@pytest.mark.parametrize("nmax,chunk,clamp", GENERAL_SOLO_CASES)
def test_bgeneral_eval_decode_one_row_matches_solo_reference(nmax, chunk,
                                                             clamp):
    g = GENERAL_SOLO_GRAPHS[nmax]()
    args = general_solo_case(g, nmax, chunk, seed=nmax + chunk, clamp=clamp,
                             tail=chunk == 4096)
    got = tref.bgeneral_eval_decode_ref(*_as_torch(args))
    want = reference_solo_general_decode(*args[:3], args[3][0], *args[4:])
    if chunk == 4096 and not clamp:
        assert _dead_lanes_past_their_block(args, got)
    assert not got[4].any()
    for a, b in zip(got[:4] + got[5:], want):
        assert a.dtype == torch.int32 and a.shape == (chunk,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int32))


@pytest.mark.parametrize("nmax", list(GENERAL_BATCHES))
def test_beval_general_chunk_matches_reference(nmax, monkeypatch):
    """Every chunk of a batched MPDP-general run on the CPU, held against
    the reference's chunk body on the same arguments and memo."""
    graphs = GENERAL_BATCHES[nmax]()
    chunk = 64 if nmax == 8 else 1024
    want_fn = jax.jit(rbatch._beval_general_chunk,
                      static_argnames=("nmax", "chunk", "pcap", "bcap"))
    real = tchunks._beval_general_chunk
    worst = [0, 0]

    def held(pairs, n_pairs, lane_count, adj_b, memo_cost, memo_rows, **kw):
        got, launched = _own_buffer(real, (pairs, n_pairs, lane_count, adj_b,
                                           memo_cost, memo_rows), kw)
        want = want_fn(*[jnp.asarray(x) for x in pairs.numpy()], n_pairs,
                       lane_count, *[jnp.asarray(a.numpy()) for a in
                                     (adj_b, memo_cost, memo_rows)],
                       pcap=pairs.shape[1], **kw)
        worst[0] = max(worst[0], _hold_chunk(got, want, f"call {worst[1]}"))
        worst[1] += 1
        return launched()

    monkeypatch.setattr(tchunks, "_beval_general_chunk", held)
    tbatch.BatchEngine([port(g) for g in graphs], chunk=chunk,
                       algorithm="mpdp_general", device="cpu").run()
    assert worst[1] > max(g.n for g in graphs)      # several chunks a level
    print(f"nmax={nmax}: {worst[1]} chunks, largest cost difference "
          f"{worst[0]} ulp")


@pytest.mark.parametrize("g", [rgen.musicbrainz_query(12, 7), rgen.clique(7, 2),
                               rgen.cycle(9, 2)],
                         ids=["musicbrainz12", "clique7", "cycle9"])
def test_eval_general_chunk_matches_reference(g, monkeypatch):
    """Every chunk of a solo MPDP-general run on the CPU (the chunk layer's
    body at bcap 1 on the one-row table), held against the reference's
    ``_eval_general_chunk`` on the same memo."""
    chunk = 512
    real = tchunks._beval_general_chunk
    worst = [0, 0]

    def held(pairs, n_pairs, lane_count, adj1, memo_cost, memo_rows, **kw):
        got, launched = _own_buffer(real, (pairs, n_pairs, lane_count, adj1,
                                           memo_cost, memo_rows), kw)
        assert kw["bcap"] == 1 and not pairs[2].any()
        rows = [jnp.asarray(x) for x in pairs.numpy()]
        want = reng._eval_general_chunk(
            rows[0], rows[1], rows[3], jnp.int32(n_pairs),
            jnp.int32(lane_count), *[jnp.asarray(a.numpy()) for a in
                                     (adj1[0], memo_cost, memo_rows)],
            nmax=kw["nmax"], chunk=kw["chunk"], pcap=pairs.shape[1])
        worst[0] = max(worst[0], _hold_chunk(
            got, [want[0], want[1], np.asarray(want[2]).reshape(()),
                  np.asarray(want[3]).reshape(())], f"call {worst[1]}"))
        worst[1] += 1
        return launched()

    monkeypatch.setattr(tchunks, "_beval_general_chunk", held)
    teng.optimize(port(g), "mpdp_general", chunk=chunk, device="cpu")
    assert worst[1] >= g.n - 1
    print(f"n={g.n}: {worst[1]} chunks, largest cost difference {worst[0]} ulp")


def general_args(nmax=16, chunk=300):
    return tuple(_as_torch(general_batch_case(nmax, chunk, seed=5)))


def test_general_decode_launch_checks_refuse_bad_inputs():
    pairs, n_pairs, lane_count, adj_b, nmax, chunk = args = general_args()
    pcap = pairs.shape[1]

    def refuse(match, **repl):
        keys = ("pairs", "n_pairs", "lane_count", "adj_b", "nmax", "chunk")
        a = dict(zip(keys, args))
        a.update(repl)
        with pytest.raises(ValueError, match=match):
            ops._launch_general_decode(*a.values())

    refuse("pairs must be", pairs=pairs.long())
    refuse("pairs must be", pairs=pairs[:3])
    refuse("pairs must be", pairs=pairs[0])
    refuse("pairs must be", pairs=pairs[:, ::2])
    refuse("n_pairs", n_pairs=0)
    refuse("n_pairs", n_pairs=pcap + 1)
    refuse("lane_count", lane_count=-1)
    refuse("lane_count", lane_count=chunk + 1)
    refuse("chunk", chunk=1 << 31)
    refuse("adj_b must be", adj_b=adj_b[:, :4])
    refuse("nmax = 24 with bcap = 4",
           adj_b=torch.zeros((4, 24), dtype=torch.int32), nmax=24)
    refuse("unsupported", adj_b=torch.zeros((1, 31), dtype=torch.int32),
           nmax=31)
    refuse("unsupported", adj_b=torch.zeros((1024, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="devices"):
        ops.bgeneral_eval_decode(pairs.to("meta"), n_pairs, lane_count, adj_b,
                                 nmax, chunk)


def bspan_args(nmax=16, k=5):
    graphs = BATCHES[nmax]()
    bcap = rbatch._bcap(len(graphs))
    fpad, foff = level_prefix(graphs, k, bcap)
    return (k, torch.from_numpy(fpad), int(foff[-1]),
            torch.from_numpy(tur.binom_table(nmax)),
            torch.from_numpy(adj_stack(graphs, bcap, nmax)), nmax)


def tree_args(nmax=16, chunk=300):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in make_tree_case(BATCHES[nmax](), nmax, chunk, 5))


@pytest.mark.parametrize("name", ["bconnectivity_span", "btree_eval_decode",
                                  "bgeneral_eval_decode", "bccp_eval_decode"])
def test_batched_lane_building_wrapper_routes_cpu_tensors(name):
    args = {"bconnectivity_span": bspan_args, "btree_eval_decode": tree_args,
            "bgeneral_eval_decode": general_args,
            "bccp_eval_decode": dpsub_decode_args}[name]()
    before = dict(ops.LAUNCHES)
    got = getattr(ops, name)(*args)
    for a, b in zip(got, getattr(tref, f"{name}_ref")(*args)):
        assert torch.equal(a, b)
    assert ops.LAUNCHES == before            # no kernel ran, none counted


def test_bspan_launch_checks_refuse_bad_inputs():
    k, foff, count, binom, adj_b, nmax = bspan_args()
    with pytest.raises(ValueError, match="adj_b must be"):
        ops._launch_bspan(k, foff, count, binom, adj_b.long(), nmax)
    with pytest.raises(ValueError, match="foff must be"):
        ops._launch_bspan(k, foff[:-1], count, binom, adj_b, nmax)
    with pytest.raises(ValueError, match="foff must be"):
        ops._launch_bspan(k, foff.long(), count, binom, adj_b, nmax)
    with pytest.raises(ValueError, match="binom must be"):
        ops._launch_bspan(k, foff, count, binom[:, :4], adj_b, nmax)
    with pytest.raises(ValueError, match="unsupported"):
        ops._launch_bspan(k, torch.zeros(1025, dtype=torch.int32), count,
                          binom, torch.zeros((1024, 16), dtype=torch.int32),
                          nmax)
    with pytest.raises(ValueError, match="count"):
        ops._launch_bspan(k, foff, 1 << 31, binom, adj_b, nmax)
    with pytest.raises(ValueError, match="k = 17"):
        ops._launch_bspan(17, foff, count, binom, adj_b, nmax)
    with pytest.raises(ValueError, match="devices"):
        ops.bconnectivity_span(k, foff.to("meta"), count, binom, adj_b, nmax)


def test_tree_decode_launch_checks_refuse_bad_inputs():
    (all_sets, eoff, loff, soff, seg0, m_b, emu_b, emv_b, adj_b, nmax, nseg,
     chunk) = args = tree_args()

    def refuse(match, **repl):
        keys = ("all_sets", "eoff", "loff", "soff", "seg0", "m_b", "emu_b",
                "emv_b", "adj_b", "nmax", "nseg", "chunk")
        a = dict(zip(keys, args))
        a.update(repl)
        with pytest.raises(ValueError, match=match):
            ops._launch_tree_decode(*a.values())

    refuse("all_sets must be", all_sets=all_sets.long())
    refuse("all_sets must be", all_sets=all_sets[:0])
    refuse("eoff must be", eoff=eoff[:-1])
    refuse("loff must be", loff=loff.long())
    refuse("soff must be", soff=soff[:1])
    refuse("m_b must be", m_b=m_b[None])
    refuse("emu_b must be", emu_b=emu_b[0])
    refuse("emv_b must be", emv_b=emv_b[:, :4])
    refuse("adj_b must be", adj_b=adj_b[:, :4])
    refuse("seg0", seg0=-1)
    refuse("chunk", chunk=1 << 31)
    refuse("nseg", nseg=0)
    with pytest.raises(ValueError, match="devices"):
        ops.btree_eval_decode(all_sets, eoff, loff, soff.to("meta"), seg0,
                              m_b, emu_b, emv_b, adj_b, nmax, nseg, chunk)


# ----------------------------------------------------------------- card --

@pytest.mark.gpu
def test_cuda_bconnectivity_span_matches_plain_version():
    """Counts of 1, 129, 32767 and 32768 lanes (past the level's end where
    it is smaller: dead lanes) and whole levels, nmax 8 and 16, bcap 4 and
    32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for nmax in (8, 16):
        graphs = (BATCHES[8]() if nmax == 8
                  else rgen.mixed_stream(32, seed=0, sizes=(12, 13, 14, 15, 16)))
        for bcap in (4, 32):
            gs = (graphs * 8)[:bcap]
            for k in (2, nmax // 2, nmax):
                fpad, foff = level_prefix(gs, k, bcap)
                for count in (1, 129, 32767, 32768, int(foff[-1])):
                    args = (k, torch.from_numpy(fpad).cuda(), count,
                            torch.from_numpy(tur.binom_table(nmax)).cuda(),
                            torch.from_numpy(adj_stack(gs, bcap, nmax)).cuda(),
                            nmax)
                    n0 = ops.LAUNCHES["bconnectivity_span"]
                    got = ops.bconnectivity_span(*args)
                    assert ops.LAUNCHES["bconnectivity_span"] == n0 + int(count > 0)
                    want = tref.bconnectivity_span_ref(*args)
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        assert a.is_cuda and torch.equal(a, b), (nmax, bcap, k, count)


@pytest.mark.gpu
def test_cuda_btree_eval_decode_matches_plain_version():
    """Chunks of 1, 129, 32767 and 32768 lanes at nmax 8 and 16 (bcap 4 and
    8), and the solo one-row tables at nmax 24 and 30."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = []
    for nmax in (8, 16):
        for chunk in (1, 129, 32767, 32768):
            cases.append(make_tree_case(BATCHES[nmax](), nmax, chunk,
                                        seed=chunk))
    for nmax, g in ((24, rgen.snowflake(20, 1)), (30, rgen.chain(25, 1))):
        dg = teng.DeviceGraph.from_graph(port(g), "cpu")
        rng = np.random.default_rng(nmax)
        for chunk in (1, 129, 32767, 32768):
            offs = teng._tree_offsets(int(rng.integers(0, 1 << 29)),
                                      int(rng.integers(0, 4096)),
                                      int(rng.integers(0, g.m)),
                                      int(rng.integers(0, chunk + 1)))
            cases.append((rng.integers(1, 1 << g.n, 4096).astype(np.int32),
                          offs[0:2], offs[2:3], offs[3:4], 0,
                          np.array([g.m], np.int32),
                          dg.emask_u[None].numpy(), dg.emask_v[None].numpy(),
                          dg.adj[None].numpy(), nmax, chunk + 1, chunk))
    for case in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                if isinstance(a, np.ndarray) else a for a in case]
        n0 = ops.LAUNCHES["btree_eval_decode"]
        got = ops.btree_eval_decode(*args)
        assert ops.LAUNCHES["btree_eval_decode"] == n0 + 1
        want = tref.btree_eval_decode_ref(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.is_cuda and torch.equal(a, b), (case[9], case[11])


@pytest.mark.gpu
def test_cuda_bgeneral_eval_decode_matches_plain_version():
    """Chunks of 1, 129, 32767 and 32768 lanes at nmax 8 and 16 (bcap 4)
    and on one-row tables at nmax 24 and 30, each on the engines' layout
    and with both clamps of the pair index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = []
    for chunk in (1, 129, 32767, 32768):
        for clamp in (False, True):
            tail = chunk == 32767
            for nmax in (8, 16):
                cases.append(general_batch_case(nmax, chunk, chunk + nmax,
                                                clamp, tail))
            for nmax, g in GENERAL_SOLO_GRAPHS.items():
                cases.append(general_solo_case(g(), nmax, chunk, chunk + nmax,
                                               clamp, tail))
    for case in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                if isinstance(a, np.ndarray) else a for a in case]
        n0 = ops.LAUNCHES["bgeneral_eval_decode"]
        got = ops.bgeneral_eval_decode(*args)
        assert ops.LAUNCHES["bgeneral_eval_decode"] == n0 + 1
        want = tref.bgeneral_eval_decode_ref(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.is_cuda and torch.equal(a, b), (case[4], case[5])


# ================================================== batched DPSUB decode ==
# bccp_eval_decode: a batched DPSUB chunk's (query, set, subset) lanes
# decoded from its offset tables.

def make_dpsub_decode_case(graphs, nmax: int, i: int, chunk: int, seed: int,
                           clamp: bool = False):
    """bccp_eval_decode arguments as ``BatchEngine._eval_dispatch`` lays
    them out: per-query set lists (inside each query's n bits) back to back
    in ``all_sets``, lanes ``sets x 2^i``, the chunk at a random lane of the
    level's last half chunk, so that a chunk longer than one lane runs past
    the level's end (dead lanes, on the padding queries).  ``clamp``: the
    last query's base moved so that its last sets lie past the end of
    ``all_sets`` (the clamped gather), seg0 moved up by 3 and nseg cut to
    5, so that segments clamp at both ends."""
    rng = np.random.default_rng(seed)
    B = len(graphs)
    bcap = rbatch._bcap(B)
    ns = rng.integers(1, 200, B)
    all_sets = np.concatenate([rng.integers(1, 1 << g.n, c) for g, c
                               in zip(graphs, ns)]).astype(np.int32)
    soff = np.zeros(B + 1, np.int64)
    np.cumsum(ns, out=soff[1:])
    loff = np.zeros(bcap, np.int32)
    loff[:B] = soff[:B]
    if clamp:
        loff[B - 1] = len(all_sets) - ns[B - 1] // 2 + 1
    spad = np.full(bcap, soff[B], np.int32)
    spad[:B] = soff[:B]
    eoff = soff << i
    lane0 = int(rng.integers(max(0, eoff[-1] - max(chunk // 2, 1)), eoff[-1]))
    epad = tchunks._offset_rows(eoff, np.array([lane0]), bcap)[0]
    p0 = min(max(int(np.searchsorted(eoff, lane0, side="right")) - 1, 0), B - 1)
    seg0 = int(soff[p0] + ((lane0 - eoff[p0]) >> i))
    nseg = chunk + 2
    if clamp:
        seg0, nseg = seg0 + 3, 5
    return (all_sets, epad, loff, spad, seg0, i, adj_stack(graphs, bcap, nmax),
            nmax, nseg, chunk)


def reference_dpsub_decode(all_sets, eoff, loff, soff, seg0, i, adj_b, nmax,
                           nseg, chunk):
    """The reference's batched DPSUB lane decode
    (``repro.core.batch._beval_dpsub_chunk``) and its ``bccp_eval_ref``,
    every lane of the chunk."""
    bcap = adj_b.shape[0]
    t = jnp.arange(chunk, dtype=jnp.int32)
    qid = jnp.clip(jnp.searchsorted(eoff, t, side="right").astype(jnp.int32)
                   - 1, 0, bcap - 1)
    local = t - eoff[qid]
    live = t < eoff[bcap]
    set_idx = local >> i
    sub = local & ((jnp.int32(1) << i) - 1)
    S = all_sets[loff[qid] + set_idx]
    lb, rb, ccp_i = rref.bccp_eval_ref(S, sub, qid, adj_b, nmax)
    seg = jnp.clip(soff[qid] + set_idx - seg0, 0, nseg - 1)
    return lb, rb, live & (ccp_i != 0), qid, seg


DPSUB_DECODE_CASES = [(nmax, chunk, i, clamp) for nmax in (8, 16)
                      for chunk, i in ((1, 3), (129, 2), (4096, 2), (4096, 6))
                      for clamp in (False, True)]


@pytest.mark.parametrize("nmax,chunk,i,clamp", DPSUB_DECODE_CASES)
def test_bccp_eval_decode_matches_reference_decode(nmax, chunk, i, clamp):
    args = make_dpsub_decode_case(BATCHES[nmax](), nmax, i, chunk,
                                  seed=nmax + chunk + i, clamp=clamp)
    got = tref.bccp_eval_decode_ref(*_as_torch(args))
    want = reference_dpsub_decode(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                    else a for a in args])
    if chunk == 4096:      # the case reaches dead lanes
        assert args[1][-1] < chunk
    if chunk == 4096 and clamp:  # and the clamps of the gather and segment
        q, seg = got[3].numpy(), got[4].numpy()
        idx = args[2][q] + ((np.arange(chunk) - args[1][q]) >> i)
        assert idx.max() >= len(args[0])
        assert (seg == 0).any() and (seg == args[8] - 1).any()
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and a.shape == (chunk,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int32))


@pytest.mark.parametrize("nmax", list(TABLES))
def test_beval_dpsub_chunk_matches_reference(nmax, monkeypatch):
    """Every chunk of a batched DPSUB run on the CPU (the ``TABLES``
    batches), held against the reference's chunk body on the same
    arguments and memo."""
    nmax, graphs = TABLES[nmax][0], TABLES[nmax][1]()
    chunk = 256 if nmax == 8 else 1024
    bcap = rbatch._bcap(len(graphs))
    want_fn = jax.jit(partial(rbatch._beval_dpsub_chunk, nmax=nmax,
                              chunk=chunk, nseg=chunk + 2, bcap=bcap,
                              pallas=False))
    real = tchunks._beval_dpsub_chunk
    lanes = PruneLanes(monkeypatch)
    worst, ties = [0, 0], []

    def held(*args, **kw):
        got = real(*args, **kw)
        want = want_fn(*[jnp.asarray(a.numpy()) if torch.is_tensor(a) else a
                         for a in args])
        worst[0] = max(worst[0], _hold_chunk(got, want, f"call {worst[1]}",
                                             lanes.last, ties))
        worst[1] += 1
        return got

    monkeypatch.setattr(tchunks, "_beval_dpsub_chunk", held)
    tbatch.BatchEngine([port(g) for g in graphs], chunk=chunk,
                       algorithm="dpsub", device="cpu").run()
    assert worst[1] > max(g.n for g in graphs)      # several chunks a level
    print(f"nmax={nmax}: {worst[1]} chunks, largest cost difference "
          f"{worst[0]} ulp, {len(ties)} segments tied by rounding "
          f"(first: {ties[:3]})")


def test_offset_rows_equal_the_per_chunk_tables():
    """One offset row per chunk of a level, built at once, equals the
    clipped, padded table each chunk used to build and copy on its own,
    at offsets inside and past the +-2^30 clip."""
    rng = np.random.default_rng(3)
    for B, bcap, scale in ((1, 4, 1), (3, 4, 1 << 12), (7, 8, 1 << 22),
                           (30, 32, 1 << 27)):
        eoff = np.zeros(B + 1, np.int64)
        np.cumsum(rng.integers(0, 1 << 12, B) * scale, out=eoff[1:])
        chunk = 32768
        lane0s = np.arange(0, max(int(eoff[-1]), 1), chunk * scale,
                           dtype=np.int64)
        rows = tchunks._offset_rows(eoff, lane0s, bcap)
        assert rows.dtype == np.int32 and rows.shape == (len(lane0s), bcap + 1)
        for row, lane0 in zip(rows, lane0s):
            el = np.clip(eoff - lane0, -(1 << 30), 1 << 30)
            epad = np.full(bcap + 1, el[B], np.int32)
            epad[: B + 1] = el
            np.testing.assert_array_equal(row, epad)
        if scale > 1 << 20:
            assert (np.abs(rows) == 1 << 30).any()


def dpsub_decode_args(nmax=16, chunk=300):
    return tuple(_as_torch(make_dpsub_decode_case(BATCHES[nmax](), nmax, 4,
                                                  chunk, 5)))


def test_dpsub_decode_launch_checks_refuse_bad_inputs():
    (all_sets, eoff, loff, soff, seg0, i, adj_b, nmax, nseg,
     chunk) = args = dpsub_decode_args()

    def refuse(match, **repl):
        keys = ("all_sets", "eoff", "loff", "soff", "seg0", "i", "adj_b",
                "nmax", "nseg", "chunk")
        a = dict(zip(keys, args))
        a.update(repl)
        with pytest.raises(ValueError, match=match):
            ops._launch_dpsub_decode(*a.values())

    refuse("all_sets must be", all_sets=all_sets.long())
    refuse("all_sets must be", all_sets=all_sets[:0])
    refuse("eoff must be", eoff=eoff[:-1])
    refuse("eoff must be", eoff=eoff.long())
    refuse("loff must be", loff=loff[None])
    refuse("soff must be", soff=soff[:1])
    refuse("adj_b must be", adj_b=adj_b[:, :4])
    refuse("unsupported", adj_b=torch.zeros((1024, 16), dtype=torch.int32))
    refuse("i = 31", i=31)
    refuse("i = -1", i=-1)
    refuse("seg0", seg0=-1)
    refuse("chunk", chunk=1 << 31)
    refuse("nseg", nseg=0)
    with pytest.raises(ValueError, match="devices"):
        ops.bccp_eval_decode(all_sets, eoff, loff, soff.to("meta"), seg0, i,
                             adj_b, nmax, nseg, chunk)


@pytest.mark.gpu
def test_cuda_bccp_eval_decode_matches_plain_version():
    """Chunks of 1, 129, 32767 and 32768 lanes at nmax 8 and 16 (bcap 4
    and 8), i in {2, 6, nmax}, with both ends of the segment clamp and a
    negative base that clamps the gather at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for nmax in (8, 16):
        for chunk in (1, 129, 32767, 32768):
            for i in (2, 6, nmax):
                for clamp in (False, True):
                    case = list(make_dpsub_decode_case(
                        BATCHES[nmax](), nmax, i, chunk, chunk + i, clamp))
                    if clamp:
                        case[2] = case[2] - np.int32(50)
                    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                            if isinstance(a, np.ndarray) else a for a in case]
                    n0 = ops.LAUNCHES["bccp_eval_decode"]
                    got = ops.bccp_eval_decode(*args)
                    assert ops.LAUNCHES["bccp_eval_decode"] == n0 + 1
                    want = tref.bccp_eval_decode_ref(*args)
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        assert a.is_cuda and torch.equal(a, b), (nmax, chunk, i)
