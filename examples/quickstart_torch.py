"""Quickstart on the PyTorch/CUDA port: optimize a join query with MPDP and
inspect the plan.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device`` is where the DP runs: ``cuda`` by default (raises without a
card), ``cpu`` for the plain PyTorch versions of the kernels.
"""
import argparse

from repro_torch.core import dpccp, engine
from repro_torch.core.joingraph import JoinGraph
from repro_torch.workloads import generators as gen


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the DP (default cuda)")
    args = ap.parse_args()

    # The paper's Figure-1 example: lineitem |x| orders |x| part |x| customer
    g = JoinGraph.make(
        n=4,
        edges=[(0, 1), (0, 2), (1, 3)],       # l-o, l-p, o-c predicates
        cards=[6e6, 1.5e6, 2e5, 1.5e5],
        sels=[1 / 1.5e6, 1 / 2e5, 1 / 1.5e5],
        names=["lineitem", "orders", "part", "customer"],
    )

    res = engine.optimize(g, "mpdp", device=args.device)
    print(f"algorithm          : {res.algorithm}")
    print(f"optimal plan cost  : {res.cost:.4g}")
    print(f"join pairs evaluated: {res.counters.evaluated} "
          f"(CCP pairs: {res.counters.ccp})")
    print(res.plan.pretty(g.names))

    # cross-check against the sequential DPCCP oracle (host)
    oracle = dpccp.solve(g)
    if abs(oracle.cost - res.cost) >= 1e-4 * oracle.cost:
        raise AssertionError(f"MPDP cost {res.cost} vs DPCCP {oracle.cost}")
    print("\nDPCCP oracle agrees:", f"{oracle.cost:.4g}")

    # a bigger query: 14-relation MusicBrainz random walk
    g2 = gen.musicbrainz_query(14, seed=7)
    r2 = engine.optimize(g2, "auto", device=args.device)
    print(f"\nMusicBrainz 14-rel: cost={r2.cost:.4g} algo={r2.algorithm} "
          f"wall={r2.wall_s:.2f}s evaluated={r2.counters.evaluated}")


if __name__ == "__main__":
    main()
