"""End-to-end example on the PyTorch/CUDA port: a *streaming*
optimize-and-execute query service over the MusicBrainz-like schema.

The port's copy of ``examples/query_service.py``, with the same stream,
constants and output lines.  A stream of generated analytic queries
(10-56 relations) flows through the PostgreSQL-style policy the paper
enables:

    n <= exact limit   -> exact MPDP through the admission-controlled
                          streaming service (``repro_torch.core.service``)
                          behind a canonical-signature plan cache
    n >  exact limit   -> UnionDP(MPDP, k)      (paper §4.2)

The exact limit is ``EXACT_LIMIT`` (14) on a single device; with
``--devices N`` it rises to ``EXACT_LIMIT_LATTICE`` (18), because the
service admits oversized queries as intra-query *lattice* flights.

``--device`` is where everything runs: ``cuda`` by default (raises without
a card), ``cpu`` for the plain PyTorch versions of the kernels.
``--devices N`` shards every batched pass (the exact tier AND UnionDP's
per-round partitions) over an N-shard mesh: the first N devices of that
type where there are N, else N logical shards of the one device (on one
card, logical shards of ``cuda:0``).  ``--pipeline`` runs every engine's
level loop pipelined (bit-identical plans).  ``--cache-file PATH``
persists the plan cache across service runs; the file format is the
reference's, so either package loads the other's file.  ``--explain``
prints, for the first UnionDP-tier query, the partition boundaries of each
round and the re-optimization loop's per-pass total costs.

Each optimized plan is executed on synthetic data by the port's hash-join
executor on the same device; results are cross-checked against a GOO plan
for semantic equality.  Each query's line ends in its cost at full
precision (``cost_exact``).

    PYTHONPATH=src python examples/query_service_torch.py [--queries 8]
        [--device cpu] [--devices 4] [--pipeline]
        [--cache-file plans.plancache]
"""
import argparse
import os
import time

EXACT_LIMIT = 14           # the reference example's budget; 25 on the paper's GPU
EXACT_LIMIT_LATTICE = 18   # with a mesh: lattice flights shard one query's
                           # lane space, so exact DP reaches further


def optimize_stream(graphs, cache, device, mesh=None, pipeline=None):
    """Optimize the whole stream on ``device``: exact-tier queries through
    the streaming service, large queries through UnionDP; ``mesh`` shards
    both batched tiers, ``pipeline`` overlaps host and device work inside
    every engine.  Returns (results, StreamReport)."""
    from repro_torch.core import service
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.heuristics import uniondp
    results = [None] * len(graphs)
    limit = EXACT_LIMIT_LATTICE if mesh is not None else EXACT_LIMIT
    exact_idx = [i for i, g in enumerate(graphs) if g.n <= limit]
    report = None
    if exact_idx:
        cfg = OptimizerConfig(cache=cache, mesh=mesh, pipeline=pipeline)
        rs, report = service.optimize_stream(
            [graphs[i] for i in exact_idx], config=cfg, device=device)
        for i, r in zip(exact_idx, rs):
            results[i] = r
    for i, g in enumerate(graphs):
        if results[i] is None:
            results[i] = uniondp.solve(g, k=10, mesh=mesh, pipeline=pipeline,
                                       device=device)
    return results, report


def make_mesh(n, device):
    """An ``n``-shard mesh on ``device``'s type: the first ``n`` devices
    where there are ``n``, else ``n`` logical shards of ``device``."""
    from repro_torch.core import shard
    from repro_torch.hostdev import ensure_host_devices
    ensure_host_devices(n)            # logical CPU devices for --device cpu
    if len(shard.take_devices(backend=device.type)) >= n:
        return shard.batch_mesh(n, backend=device.type)
    return shard.batch_mesh([device] * n)


def load_cache(path):
    from repro_torch.core.plancache import PlanCache
    if path and os.path.exists(path):
        cache = PlanCache.load(path)
        state = "stale, invalidated" if cache.stale_load else \
            f"{len(cache)} entries"
        print(f"plan cache: loaded {path} ({state})")
        return cache
    return PlanCache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the DP and the executor "
                         "(default cuda)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard batched passes over N devices (logical "
                         "shards of --device where fewer exist)")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined engines: overlap host compaction with "
                         "device evaluation (bit-identical plans)")
    ap.add_argument("--cache-file", type=str, default=None,
                    help="persist the plan cache here across service runs")
    ap.add_argument("--explain", action="store_true",
                    help="print the chosen partition boundaries and "
                         "per-round re-optimization costs for the first "
                         "UnionDP-tier query")
    args = ap.parse_args()

    from repro_torch.core.engine import resolve_device
    from repro_torch.core.plan import validate_plan
    from repro_torch.execution import executor as ex
    from repro_torch.heuristics import goo
    from repro_torch.workloads import generators as gen

    device = resolve_device(args.device)
    mesh = make_mesh(args.devices, device) if args.devices else None
    sizes = [10, 12, 16, 24, 40, 56][: args.queries] + \
            [12] * max(0, args.queries - 6)
    # the stall-restarting walk reaches every size up to the full schema;
    # disjoint seed windows keep stream entries distinct (no fake cache hits)
    graphs = [gen.musicbrainz_query(n, seed=100 + 50 * qi)
              for qi, n in enumerate(sizes)]
    cache = load_cache(args.cache_file)

    t0 = time.perf_counter()
    stream, report = optimize_stream(graphs, cache, device, mesh=mesh,
                                     pipeline=args.pipeline or None)
    total_opt = time.perf_counter() - t0

    total_exec = 0.0
    for qi, (g, res) in enumerate(zip(graphs, stream)):
        validate_plan(res.plan, g)

        data = ex.generate_data(g, max_rows=300, seed=qi, device=device)
        out, exec_s = ex.execute_timed(res.plan, g, data)
        # semantic cross-check vs an independently derived plan
        ref = ex.execute(goo.solve(g).plan, g, data)
        if not (out.rels == ref.rels
                and out.rows.shape == ref.rows.shape
                and bool((out.canonical() == ref.canonical()).all())):
            raise AssertionError(f"Q{qi}: the plan's result differs from "
                                 "GOO's plan's")

        total_exec += exec_s
        print(f"Q{qi}: n={g.n:3d} algo={res.algorithm:14s} "
              f"cost={res.cost:10.4g} exec={1e3*exec_s:6.1f}ms rows={out.count} "
              f"cost_exact={float(res.cost)!r}")
    if args.explain:
        for qi, (g, res) in enumerate(zip(graphs, stream)):
            if "partitions" not in res.info:
                continue               # exact-tier query: no partitioning
            print(f"\nexplain Q{qi} (n={g.n}, {res.algorithm}):")
            for rnd, groups in enumerate(res.info["partitions"]):
                names = ["{" + ",".join(g.names[v] for v in gr) + "}"
                         for gr in sorted(groups, key=len, reverse=True)]
                print(f"  round {rnd}: {len(groups)} partitions  "
                      + " ".join(names))
            rc = res.info["round_costs"]
            print("  re-optimization: " + " -> ".join(f"{c:.6g}" for c in rc)
                  + (f"  ({len(rc) - 1} accepted pass"
                     + ("es" if len(rc) != 2 else "") + ")"))
            break                      # one worked example is the contract
    if report is not None and report.flights:
        # the engines honor REPRO_PIPELINE when --pipeline is absent; label
        # the mode that actually ran, not just the flag
        pipelined = args.pipeline or os.environ.get("REPRO_PIPELINE") == "1"
        print(f"\nflights ({'pipelined' if pipelined else 'synchronous'} "
              "engines, finalize overlapped):")
        for f in report.flights:
            tag = " lattice" if f.lattice else ""
            print(f"  (nmax={f.nmax:2d}, {f.space:12s}) x{len(f.queries)} "
                  f"wall={1e3*f.wall_s:7.1f}ms "
                  f"finalize={1e3*f.finalize_s:6.1f}ms{tag}")
        pct = report.latency_percentiles()
        print("exact-tier latency: " +
              " ".join(f"p{p}={1e3*v:.1f}ms" for p, v in pct.items()))
    print(f"\nservice done: {len(sizes)} queries on {device}, "
          f"opt {total_opt:.2f}s (streamed flights), exec {total_exec:.2f}s, "
          f"plan cache {cache.stats.hits} hits / {cache.stats.misses} misses")
    if args.cache_file:
        cache.save(args.cache_file)
        print(f"plan cache: saved {len(cache)} entries -> {args.cache_file}")


if __name__ == "__main__":
    main()
