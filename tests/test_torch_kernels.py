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
* ``gpu``-marked tests hold each CUDA kernel against its plain version on
  the card (they skip without one).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from math import comb

from repro.core import bitset as rbs, engine as reng, unrank as rur
from repro.kernels import ccp_eval as rpallas, ref as rref
from repro.workloads import generators as rgen
from repro_torch.core import unrank as tur
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
