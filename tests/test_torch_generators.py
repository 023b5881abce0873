"""The port's generators and host helpers vs the JAX reference's, on the CPU.

* ``hypergraph_query`` gives the reference's graph seed for seed (wire
  dicts equal), duplicate inner edges merged by the same rule;
* the mirror of ``tests/test_generators.py``: the port's ``mixed_stream``
  synthesizes byte-identical graphs across processes, and the same bytes
  as the reference's;
* the mirror of ``tests/test_conflicts.py``'s construction-time checks
  (the same ``ValueError`` texts) and of
  ``test_generator_streams_always_feasible``;
* the host helpers ``blocks.np_cut_vertices``, ``dpccp.enumerate_csg``,
  ``dpccp.ccp_count`` and ``unrank.np_unrank_ksubset`` equal the
  reference's.
"""
import hashlib
import os
import subprocess
import sys
from math import comb

import numpy as np
import pytest

from repro.core import blocks as rbl, dpccp as rdpccp, unrank as rur
from repro.daemon.protocol import graph_to_wire
from repro.workloads import generators as rgen
from repro_torch.core import blocks as tbl, dpccp as tdpccp, unrank as tur
from repro_torch.core import joingraph as tjg
from repro_torch.core.joingraph import JoinGraph
from repro_torch.workloads import generators as tgen
from tests.helpers import rand_graph
from tests.test_torch_batch import one_torch_thread, port  # noqa: F401

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------- hypergraph query --

@pytest.mark.parametrize("n", [5, 7, 12, 16, 20])
def test_hypergraph_query_matches_seed_for_seed(n):
    for seed in range(10):
        got = tgen.hypergraph_query(n, seed=seed)
        assert tjg.graph_to_wire(got) == \
            graph_to_wire(rgen.hypergraph_query(n, seed=seed)), (n, seed)
        assert got.is_connected() and not got.typed


def test_hypergraph_query_options_and_merges():
    # wider and more hyperedges: lowered cliques overlap the chain and each
    # other, so duplicate inner edges merge
    for seed in range(4):
        got = tgen.hypergraph_query(9, seed=seed, n_hyper=4, arity=4)
        want = rgen.hypergraph_query(9, seed=seed, n_hyper=4, arity=4)
        assert tjg.graph_to_wire(got) == graph_to_wire(want)
        assert got.m < 8 + 4 * comb(4, 2)


# ------------------------------------------------ cross-process determinism --

_CHILD = r"""
import hashlib, sys
import numpy as np
from repro_torch.workloads.generators import mixed_stream
h = hashlib.sha256()
for g in mixed_stream(12, seed=int(sys.argv[1])):
    h.update(str(g.n).encode())
    h.update(str(sorted(g.edges)).encode())
    h.update(np.asarray(g.log2_card, dtype=np.float64).tobytes())
    h.update(np.asarray(g.log2_sel, dtype=np.float64).tobytes())
    h.update(",".join(g.names).encode())
print(h.hexdigest())
"""


def _digest_in_subprocess(seed: int) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _CHILD, str(seed)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def _digest(stream) -> str:
    h = hashlib.sha256()
    for g in stream:
        h.update(str(g.n).encode())
        h.update(str(sorted(g.edges)).encode())
        h.update(np.asarray(g.log2_card, dtype=np.float64).tobytes())
        h.update(np.asarray(g.log2_sel, dtype=np.float64).tobytes())
        h.update(",".join(g.names).encode())
    return h.hexdigest()


def test_same_seed_identical_across_processes():
    a = _digest_in_subprocess(0)
    b = _digest_in_subprocess(0)
    assert a == b
    # the parent process (JAX and the reference loaded) and the
    # reference's stream agree too
    assert a == _digest(tgen.mixed_stream(12, seed=0))
    assert a == _digest(rgen.mixed_stream(12, seed=0))


def test_distinct_seeds_distinct_streams():
    assert _digest(tgen.mixed_stream(12, seed=0)) != \
        _digest(tgen.mixed_stream(12, seed=1))


def test_repeat_call_in_process_identical():
    assert _digest(tgen.mixed_stream(12, seed=3)) == \
        _digest(tgen.mixed_stream(12, seed=3))


# ----------------------------------------------- construction-time checks --

def test_duplicate_edge_kinds_raise():
    with pytest.raises(ValueError, match="duplicate"):
        JoinGraph.make(3, [(0, 1), (1, 0), (1, 2)],
                       [100.0, 200.0, 300.0], [0.1, 0.2, 0.1],
                       kinds=["left", "semi", "inner"])


def test_duplicate_inner_edges_merge():
    g = JoinGraph.make(3, [(0, 1), (1, 0), (1, 2)],
                       [100.0, 200.0, 300.0], [0.1, 0.2, 0.1])
    assert len(g.edges) == 2


def test_non_bridge_non_inner_raises():
    with pytest.raises(ValueError, match="bridge"):
        JoinGraph.make(3, [(0, 1), (1, 2), (0, 2)],
                       [100.0, 200.0, 300.0], [0.1, 0.2, 0.1],
                       kinds=["left", "inner", "inner"])


def test_tes_deadlock_raises():
    with pytest.raises(ValueError, match="infeasible"):
        JoinGraph.make(4, [(0, 1), (1, 2), (2, 3)],
                       [10.0, 20.0, 30.0, 40.0], [0.1, 0.1, 0.1],
                       kinds=["left", "inner", "left"],
                       ldirs=[0, 0, 1])


def test_generator_streams_always_feasible():
    for i, g in enumerate(tgen.mixed_joins_stream(12, seed=7,
                                                  sizes=(5, 8, 11))):
        assert g.n in (5, 8, 11)
        for kg in (tgen.typed_query(14, seed=i, base="chain",
                                    noninner=0.6, mn=0.5),
                   tgen.hypergraph_query(7, seed=i)):
            assert kg.full_set == (1 << kg.n) - 1


# -------------------------------------------------------------- host helpers --

HELPER_GRAPHS = [rand_graph(n, extra, seed) for n, extra, seed in
                 [(6, 0, 1), (7, 3, 2), (8, 5, 3), (9, 2, 4), (10, 7, 5)]] + \
    [rgen.clique(6, 1), rgen.hypergraph_query(9, seed=2)]
HELPER_IDS = [f"g{i}" for i in range(len(HELPER_GRAPHS))]


@pytest.mark.parametrize("g", HELPER_GRAPHS, ids=HELPER_IDS)
def test_cut_vertices_match_reference(g):
    adj = np.asarray(g.adjacency(), np.int32)
    for s in range(1, 1 << g.n):
        assert tbl.np_cut_vertices(s, adj) == rbl.np_cut_vertices(s, adj), s


@pytest.mark.parametrize("g", HELPER_GRAPHS, ids=HELPER_IDS)
def test_enumerate_csg_and_ccp_count_match_reference(g):
    t = port(g)
    got = tdpccp.enumerate_csg(t.n, t.adjacency())
    assert got == rdpccp.enumerate_csg(g.n, g.adjacency())
    assert len(set(got)) == len(got)
    assert tdpccp.ccp_count(t) == rdpccp.ccp_count(g)


def test_unrank_ksubset_matches_reference():
    for n in (1, 5, 9, 13):
        for k in range(n + 1):
            got = [tur.np_unrank_ksubset(r, k, n) for r in range(comb(n, k))]
            assert got == [rur.np_unrank_ksubset(r, k, n)
                           for r in range(comb(n, k))]
            assert len(set(got)) == len(got)
            assert all(bin(s).count("1") == k and s < (1 << n) for s in got)
