#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Usage:  python3 chip_smoke.py        (one CUDA card; exits non-zero on any
                                      failure, and without a card)

Phases, in order, none of them caught:
  1. device  — card name/count and ``nvidia-smi`` name + power limit;
  2. build   — compile ``kernels/csrc/ccp_eval.cu`` with nvcc for sm_90a;
  3. kernels — each of the sixteen CUDA entry points against its plain
     PyTorch version on the same card tensors, bit for bit, lanes built
     with numpy from a seed over real generator graphs: the four batched
     kernels and the four batched forms that build their own lanes
     (``bconnectivity_span`` over a level span, ``bccp_eval_decode`` over
     a DPSUB chunk at several i, ``btree_eval_decode`` over an MPDP:Tree
     chunk, ``bgeneral_eval_decode`` over an MPDP-general chunk's pair
     table, each with dead and clamped lanes) at L or count = 32768 and
     the ragged 1, 129, 32767, nmax in {8, 16}, bcap in {4, 32}; the
     three solo-engine kernels, and ``btree_eval``,
     ``btree_eval_decode`` and ``bgeneral_eval_decode`` on the one-row
     tables the solo evaluates give them, at the same L and nmax in {8,
     16, 24, 30}; the two solo
     forms that build their own lanes (``connectivity_span`` over a rank
     span, ``ccp_eval_dpsub`` over a DPSUB chunk with dead and clamped
     lanes) at count or chunk in {1, 129, 32767, 32768} and nmax in {8,
     16, 24, 30}, and ``connectivity_span`` at d4's largest span
     (chain(25), level 12, 5,200,300 ranks at nmax 30).  Then stream (a)
     once, with its ``bconnectivity_span``, ``btree_eval_decode`` and
     ``bgeneral_eval_decode`` calls held against their plain versions and
     the busiest of each kept, stream (b) once with its
     ``bccp_eval_decode`` calls held the same way, and d1 once, with its
     ``bgeneral_eval_decode`` calls held the same way.
     Times by CUDA events (kernel and plain version) and the bound of
     each, at L = 32768 with nmax = 16, bcap = 32 (batched) or nmax = 24
     (solo); ``ccp_eval_dpsub`` on d3's real level sets,
     ``connectivity_span`` at L = 32768 (printed) and at d4's span (the
     JSON line), the two batched forms at L = 32768, nmax 16, bcap 32
     (printed) and at stream (a)'s busiest level span, tree chunk and
     general chunk (the JSON line), ``bccp_eval_decode`` at stream (b)'s
     busiest chunk (the JSON line), ``bgeneral_eval_decode`` also at d1's
     busiest chunk (printed); ``phase_a_blocks`` (phase A of MPDP-general)
     on random sets of every graph above at nmax 8, 16, 24 and 30, two
     widths each, and on every level of stream (a), d1 and l1 (d1 on the
     lattice, one shard), timed at each level of musicbrainz_query(16, 1)
     (printed: the largest level and the sum) and at the largest level of
     musicbrainz_query(20, 0) (the JSON line); the fused evaluate forms
     (``btree_eval_prune``, ``bgeneral_eval_prune``: the two decodes with
     the chunk bodies' cost, prune and counts in the kernel) at the same
     shapes as their decode forms with random and tied memo tables, on
     every call of stream (a), d1, a clique of 15, musicbrainz_query(16,
     1) and snowflake(16, 1), timed beside the decode kernel and torch
     epilogue they replaced (card and host) at the busiest chunk of each
     of the last three (the clique's and the snowflake's the JSON lines)
     and of stream (a);
  4. batched path — ``optimize_many`` on ``cuda`` over three streams, every
     plan validated and every cost held against the host DPccp oracle
     (relative 1e-4), ``Counters`` and costs of stream (c) and the first
     four queries of (a) and (b) against the port's own ``device="cpu"``
     run (exact / relative 1e-5), one ``bconnectivity_span`` launch per
     level and flight, launch counters read around exactly this path;
     then a ``torch.profiler`` window over stream (a);
     on every path one ``bgeneral_eval_decode`` (typed) or
     ``bgeneral_eval_prune`` launch per MPDP-general chunk, the same of
     the tree forms per MPDP:Tree chunk, one ``bccp_eval_decode`` launch
     per batched DPSUB chunk, one
     ``phase_a_blocks`` launch per (query, level) on phase A's sparse path and
     none of the seven set-given kernels the lane-building forms replaced
     (``OFF_PATH``);
  5. solo path — ``engine.optimize`` on ``cuda`` over parts d1-d5 (MPDP-
     general at nmax 24, MPDP:Tree at nmax 24, DPSUB, the nmax-30 bucket,
     then dpsize, dpccp, frontier expansion and ``optimize_many``'s solo
     route), each plan validated and each cost held against DPccp
     (relative 1e-4), d1, d3 and d5 against the ``device="cpu"`` run
     (``Counters`` exact, costs relative 1e-5), one ``connectivity_span``
     launch per level span, and in d5's ``optimize_many`` one
     ``bconnectivity_span`` launch per level and flight, launch counters
     read around exactly this path; then a ``torch.profiler`` window over
     d1;
  6. typed path — queries with LEFT, FULL, SEMI and ANTI edges:
     ``optimize_many`` on ``cuda`` over ``mixed_joins_stream(16, seed=0,
     sizes=12..16)`` under ``auto`` (MPDP:Tree and MPDP-general flights)
     and ``dpsub``, and ``engine.optimize`` over ``typed_query(20,
     seed=11, base="musicbrainz")`` under ``mpdp`` and ``typed_query(17,
     ...)`` under ``dpsub``; every plan validated (conflict rules
     included), every cost within 1e-4 of the typed host DPccp (run in
     worker processes meanwhile), ``Counters`` and costs of the stream's
     queries of 13 relations or fewer against the port's ``device="cpu"``
     run, ``dpsize`` refusing a typed graph with ``ValueError``; launch
     counters read around exactly this path, which runs all six
     lane-building forms and no set-given kernel;
  7. heuristics path — ``uniondp.solve`` and ``idp.solve`` on ``cuda``
     over parts h1-h6 (``musicbrainz_query(56, seed=256)`` under both at
     k = 15, ``snowflake(400, seed=7)`` under both at k = 15,
     ``snowflake(80, seed=7)`` under IDP2 at k = 20, whose 17-20-relation
     subproblems go solo, ``musicbrainz_query(30, seed=230)`` under IDP2
     with the ``dpsub`` subsolver at k = 12, and UnionDP over
     ``typed_query(40, seed=11, base="musicbrainz")``); every plan
     validated (conflict rules included) and its cost equal to
     ``cost_plan`` of its plan, UnionDP on h1 and h3 at most GOO x (1 +
     2e-3) with non-increasing ``round_costs``, h1, h2 and h5 held round
     by round against the port's ``device="cpu"`` run (run in worker
     processes meanwhile: equal subproblems and plan shapes per
     sub-solver call, a differing shape only as a shown tie), one
     ``bconnectivity_span`` launch per level and flight and one
     ``connectivity_span`` launch per level span of each solo
     subproblem; per part its wall, sub-solver calls, flights,
     subproblems, the seconds inside ``optimize_many`` against the
     heuristic's own host seconds, and launches;
  8. service path — ``service.optimize_stream`` on ``cuda``: s1, stream
     (a) plus d1's graph (solo) under ``auto``, once synchronous and
     three times pipelined; s2, stream (b) plus d3's graph (solo) under
     ``dpsub``, synchronous and pipelined; every pipelined run bit for bit
     the synchronous one (cost ``==``, plan shape, ``Counters``,
     ``algorithm``) with equal launches per kernel, s1 also equal to phase
     4's stream (a) and phase 5's d1, the flights ``admit``'s, one solo
     query; s3, s1's stream plus 16 relabelled duplicates through a
     ``PlanCache`` (each distinct query computed once, the duplicates
     deferred hits), saved, loaded and run again: all 49 hits, no flight,
     no launch, the first pass's plans and each cost ``==`` its
     ``cost_plan``; s4, ``uniondp.solve`` and ``idp.solve`` on h1's graph
     with ``pipeline=True``, round by round equal to phase 7's runs; then
     a profile of one pipelined s1 run, which raises unless every
     ``bconnectivity_span`` launch ran on another CUDA stream than the
     evaluate kernels and prints the device time the two streams overlap.
  9. daemon path — ``repro_torch.daemon`` on ``cuda``: an
     ``OptimizerDaemon`` in this process on a unix socket, driven by a
     ``DaemonClient``: v1, s1 (``auto``, synchronous) bit for bit phase
     8's synchronous s1 with equal launches; v2, s1 pipelined: all hits,
     no flight, no launch, no build since serving started; v3, s2
     (``dpsub``) bit for bit phase 8's s2 with equal launches; v4, a new
     stream (``mixed_stream(32, seed=2, sizes=12..16)`` plus
     ``musicbrainz_query(20, seed=13)``) with ``deadline_s`` a quarter of
     v1's wall: degraded results stop short, cost between the exact run's
     and GOO's, are not cached, and the reply's overrun is printed; launch
     counters read around exactly v1-v4.  v5, the fake deadline clock of
     ``tests/test_faults.py`` on the card (stream (c)'s flights at every
     level, synchronous and pipelined, and d1 at k 4, 8, 12) against the
     port's cpu run in worker processes; v6, ``python -m
     repro_torch.daemon`` as its own process with ``REPRO_FAULTS``: a
     crashed worker answered retryably, a chunk fault mid-flight answered
     with a structured error, then s1 bit for bit under the policy table,
     and a SIGTERM drain (exit 0) to a cache file that serves all of s1 as
     hits.
 10. sharded path — batch sharding and the lattice on logical shards of
     the one card (``shard.batch_mesh([cuda:0] * N)``; they run one after
     another): x1, streams (a)-(c) with ``devices=1``, bit for bit phase
     4's with its launches per kernel; x2, (a) and (b) on 4 shards, x3,
     (c) on 3 (inert pads), and (b), (c) pipelined on 4, each bit for bit
     phase 4's, ``bconnectivity_span`` launches predicted per flight,
     level and shard and the evaluate launches per shard and chunk from
     x1's lanes per query and level; l1-l4, d1 through
     ``engine.optimize(lattice_devices=1)`` and on 4 shards (also
     pipelined), d2, d3 (``dpsub``, nmax 18) and t20 on 4, each equal to
     its solo run (cost ``==``, plan shape, ``Counters``) with one
     ``min_left_commit`` a level, equal memo replicas and launches as
     predicted from its lane totals, d1 also against the port's cpu
     lattice on 2 shards in a worker process; x4, s1 through the service
     on 4 shards (d1 a lattice flight) equal to phase 8's; x5, h4 with
     ``devices=1`` (its 18- and 20-relation subproblems on the lattice)
     round by round equal to phase 7's; x6, an ``OptimizerDaemon(
     devices=1)`` serving s1 equal to phase 8's, and a request pinning
     ``devices=2`` answered with the structured error naming 1 card.  No
     result may carry ``redispatched`` and no sharded flight may fail.
 11. execute path — the optimize-and-execute path (``execution.executor``
     on the card): e1, the reference's Fig. 10 setting,
     ``musicbrainz_query(n, seed=n)`` for n in {8, 10, 12} on
     ``generate_data(max_rows=3000, seed=1)``, and e2, n = 12 at
     ``max_rows=30000``: the plans of solo ``mpdp``, ``dpccp``, ``dpsub``,
     GOO, IDP2 and UnionDP (k 5) executed on the card, the mpdp and dpccp
     plans' raw rows == the port's cpu executor's, every plan's
     ``canonical()`` == mpdp's, one Fig. 10 line per plan (``opt_ms``,
     ``exec_ms``, ``exec_over_opt``, the largest intermediate) and the
     peak memory; e3, ``hypergraph_query(n, seed=s)`` for n in {12, 14,
     16}, s in 0-3 through ``optimize_many(auto)`` (MPDP-general flights)
     and ``hypergraph_query(20, seed=0)`` through solo ``optimize``, each
     plan valid, within 1e-4 of DPccp, ``Counters`` and costs as the cpu
     run (a worker process), executed at ``max_rows=300`` with its rows ==
     GOO's plan's (where a join packs four or more predicates, the packed
     key wraps and may collide as in the reference: then equal after the
     rows that fail a predicate are dropped, and shown), and a K4 whose
     packed keys wrap, raw rows == the cpu executor's; launch counters read
     around exactly e1-e3; a ``torch.profiler`` window over e1's n = 10
     execution.  Then q1-q3, the port's examples as processes
     on the card: ``quickstart_torch.py``, ``query_service_torch.py
     --queries 6`` and that with ``--pipeline --cache-file`` twice, each
     exit 0, its lines (``algo``, ``rows``, cost within 1e-5) == its
     ``--device cpu`` run's, the second q3 run all hits.
 12. serve path — the LM serving path (``models``, ``launch.serve``; torch
     ops, none of the kernels): m1, gemma3_12b at full width (11.77 B
     params, bf16 serving copy from a seeded ``torch.Generator`` on the
     card) through ``launch.serve.run``, batch 4, prompt 1,040 (past the
     local layers' 1,024-slot rings), gen 16, ``max_len`` 1,152: tokens/s,
     each decode step by CUDA events against its bound (weight and cache
     bytes over 3.35 TB/s), peak and held memory; ``make_prefill_step`` on
     the same prompt, its last logits against the decode loop's at
     position 1,039 (printed, with the bf16 noise floor: the same prefill
     batched vs row by row); a ``torch.profiler`` window over one decode
     step (top device operations, idle share); then the same model
     computing in f32 from the same seed, its decode loop over the prompt
     held against its prefill (corr > 0.999, rel < 0.01).  m2, every arch
     at ``reduced()`` (MoE also at capacity factor 8) on the card against
     the port's cpu run from the same params: forward, ten decode steps
     and prefill within the whole-model bounds (corr > 0.998, rel < 0.01;
     MLA 0.99, 0.015), and ``tests/test_models.py``'s decode-vs-forward
     check on its four archs (held at one seed, printed for four).  m3,
     ``examples/serve_lm_torch.py`` as a process on the card, exit 0.
     Launch counters read around m1-m3: all zero.
 13. train path — the training path (``make_train_step`` with remat,
     AdamW, checkpoints, ``launch.train``; torch ops, none of the
     kernels): r1, mamba2_370m at full width, seq 4,096, global batch 16
     as 2 microbatches of 8, 6 steps (finite losses and grad norms, step
     ms by CUDA events against 6 N tokens over the bf16 peak, tokens/s,
     memory) and a profiled step; then, in a process of its own started
     with cuBLAS's workspace variable (so no other phase runs under it),
     4 of those steps with the trainer's deterministic kernels, their
     step time against r1's.  r2, the full-width model in f32, loss and
     gradients on cuda against cpu (rel < 1e-4, corr >= 0.9999).  r3, r1's
     state saved and restored bit for bit.  r4, every arch at
     ``reduced()``: 8 steps lower the loss, step 0 within 1 % of the cpu
     run.  r5, ``launch.train`` crashed and resumed to the uninterrupted
     run's final loss, and ``examples/train_tiny_lm_torch.py``, as
     processes.  Launch counters read around r1-r5, the deterministic
     process's included: all zero.
 14. dry-run — the dry-run tooling (``launch.dryrun``, ``roofline``,
     ``report``, ``distributed.ctx``; torch ops on meta tensors, none of
     the kernels): y1, r1's cell (mamba2_370m at full width, seq 4,096,
     global batch 16 as 2 microbatches of 8, remat on) measured by
     ``dryrun._measure`` on meta tensors over ``Mesh((1, 1))`` (in a
     worker process, as y2's and y3's, while the card runs), and the
     same step on the card's tensors (r1's weights and first batch) under
     the same ``FlopCounterMode`` and byte-counting mode: FLOPs and bytes
     accessed equal exactly, argument bytes equal the state's and the
     batch's on the card, the predicted peak over
     ``max_memory_allocated`` inside [0.5, 1.05], the roofline bound at
     the H100's peaks at most the measured median of 3 steps (CUDA
     events), the ratio printed.  y2, m1's decode step (gemma3_12b at full
     width, f32 masters as the dry-run's decode cell reads them, batch 4,
     cache 1,152, position 1,040), the same checks over 10 steps.  y3,
     ``run_cell`` on the single-pod mesh for ``Y3_CELLS`` (every arch's
     ``decode_32k``, and mamba2_370m's ``prefill_32k``: the cells that
     take seconds on meta; the rest, minutes a cell, are left to the CLI
     and listed), their table through ``report.render``.  Launch counters read around y1-y3:
     all zero.
On every path the evaluates make one launch a chunk: ``ChunkCalls``
counts the MPDP-general, MPDP:Tree and batched DPSUB chunk bodies.
The last three lines of standard output are a JSON object with one entry
per kernel, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import gc
import itertools
import json
import multiprocessing
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor
from math import comb

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core import batch, dpccp, engine, faults, service  # noqa: E402
from repro_torch.core import blocks, chunks, lattice, shard  # noqa: E402
from repro_torch.core import bitset as bs  # noqa: E402
from repro_torch.core import unrank as ur  # noqa: E402
from repro_torch.core.config import MAX_FLIGHT, OptimizerConfig  # noqa: E402
from repro_torch.core.joingraph import JoinGraph, graph_to_wire  # noqa: E402
from repro_torch.core.plan import (Plan, cost_plan, join_plans,  # noqa: E402
                                   leaf_plan, validate_plan)
from repro_torch.core.plancache import PlanCache, canonical_signature  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.sharding import partition_lanes  # noqa: E402
from repro_torch.core.policy import PolicyTable  # noqa: E402
from repro_torch.daemon import (DaemonClient, DaemonError,  # noqa: E402
                                OptimizerDaemon)
from repro_torch.execution import executor as ex  # noqa: E402
from repro_torch.heuristics import goo, idp, uniondp  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import dryrun, report, roofline, serve  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.data import SyntheticLM  # noqa: E402
from repro_torch.train.optimizer import init_train_state  # noqa: E402
from repro_torch.tree import leaves as tree_leaves, leaves_with_path  # noqa: E402
from repro_torch.workloads import generators as gen  # noqa: E402

INT32_OPS_S = 132 * 64 * 1.98e9       # 132 SMs x 64 INT32 lanes x 1.98 GHz
FP32_OPS_S = 132 * 128 * 1.98e9       # 132 SMs x 128 FP32 lanes x 1.98 GHz:
                                      # also the SMs' dispatch rate of all
                                      # operations
OPS_PER_STEP = 3                      # one set-bit step: ffs, row load, OR
OPS_PER_LANE = 12                     # per-lane decode, loads, stores
UNRANK_OPS_PER_STEP = 4               # one unrank step: load C(v,kk), compare,
                                      # subtract/OR, decrement
DPSUB_DECODE_OPS = 6                  # add, shift, add, and, add, clamp
BDPSUB_DECODE_OPS = 10                # subtract, shift, mask, add, clamps,
                                      # the seg add, subtract and clamp
SEARCH_OPS = 4                        # one binary-search step: load, compare,
                                      # select, halve
TREE_DECODE_OPS = 30                  # subtract, max, int32 division (about
                                      # 20 instructions), floor fix-up, clamps,
                                      # adds, two edge loads, the seg clamp
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
    "bconnectivity_span": ((), 3, "src/repro/kernels/ccp_eval.py:133 + the "
                           "batched unrank of src/repro/core/batch.py:110-127"),
    "bccp_eval": (("S", "sub", "qid"), 3, "src/repro/kernels/ccp_eval.py:142"),
    "bccp_eval_decode": ((), 5, "src/repro/kernels/ccp_eval.py:142 + the "
                         "batched DPSUB decode of src/repro/core/batch.py:"
                         "145-152"),
    "btree_eval": (("S", "ub", "vb", "qid"), 2,
                   "src/repro/kernels/ccp_eval.py:159"),
    "btree_eval_decode": ((), 5, "src/repro/kernels/ccp_eval.py:159 + the "
                          "MPDP:Tree decode of src/repro/core/batch.py:202-214"),
    "bgeneral_eval": (("S", "block", "r", "qid"), 3,
                      "src/repro/kernels/ccp_eval.py:184"),
    "bgeneral_eval_decode": ((), 6, "src/repro/kernels/ccp_eval.py:184 + the "
                             "general decode of src/repro/core/batch.py:259-283 "
                             "and src/repro/core/engine.py:253-268"),
    "btree_eval_prune": ((), 1, "src/repro/kernels/ccp_eval.py:159 + the "
                         "MPDP:Tree decode and the epilogue (cost, prune, "
                         "counts) of src/repro/core/batch.py:202-243"),
    "bgeneral_eval_prune": ((), 1, "src/repro/kernels/ccp_eval.py:184 + the "
                            "general decode and the epilogue (cost, prune, "
                            "counts) of src/repro/core/batch.py:259-305"),
    "phase_a_blocks": ((), 1, "no Pallas kernel: the jitted blocks_chunk of "
                       "src/repro/core/blocks.py:236 + the pair compaction "
                       "of src/repro/core/blocks.py:274"),
}
SOLO = ("connectivity", "ccp_eval", "grow_pair")
SPAN_FORMS = ("connectivity_span", "ccp_eval_dpsub")
BATCHED = ("bconnectivity", "bccp_eval", "btree_eval", "bgeneral_eval")
BATCHED_FORMS = ("bconnectivity_span", "bccp_eval_decode",
                 "btree_eval_decode", "bgeneral_eval_decode")
SOLO_CHECKED = SOLO + ("btree_eval",)   # btree_eval on a one-row table
# the tree and general evaluates of inner-join flights: the decode forms
# with the chunk epilogue in the kernel (typed flights keep the decodes)
FUSED_FORMS = ("btree_eval_prune", "bgeneral_eval_prune")
FUSED_OF = {"btree_eval_decode": "btree_eval_prune",
            "bgeneral_eval_decode": "bgeneral_eval_prune"}
INNER_FORMS = ("bconnectivity_span", "bccp_eval_decode") + FUSED_FORMS
# what each path runs: the set-given kernels left it for the forms that
# build their own lanes, and must make no launch there
BATCHED_PATH = INNER_FORMS + ("phase_a_blocks",)
SOLO_PATH = SPAN_FORMS + FUSED_FORMS + ("phase_a_blocks",)
TYPED_PATH = SPAN_FORMS + BATCHED_FORMS
# the heuristics' subproblems: batched flights, and 17-20-relation ones
# solo (a DPSUB subproblem goes solo only past 16 relations: not here)
HEUR_PATH = INNER_FORMS + ("connectivity_span",)
OFF_PATH = ("connectivity", "ccp_eval", "grow_pair", "bconnectivity",
            "bccp_eval", "btree_eval", "bgeneral_eval")
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


def bspan_inputs(graphs, bcap: int, nmax: int, count: int, seed: int):
    """bconnectivity_span arguments over the first bcap graphs: the global
    rank prefix of a random level k, ``count`` lanes from 0 (past the
    level's end where it is smaller: dead lanes)."""
    rng = np.random.default_rng(seed)
    gs = graphs[:bcap]
    k = int(rng.integers(2, nmax + 1))
    foff = np.zeros(bcap + 1, np.int64)
    np.cumsum([comb(g.n, k) for g in gs], out=foff[1:])
    adj = np.stack([adj_table(g, nmax).cpu().numpy() for g in gs])
    return (k, torch.from_numpy(foff.astype(np.int32)).to(DEV), count,
            binom_on_card(nmax), torch.from_numpy(adj).to(DEV), nmax)


def tree_inputs(graphs, bcap: int, nmax: int, chunk: int, seed: int):
    """btree_eval_decode arguments laid out as ``BatchEngine._eval_dispatch``
    lays them out, over bcap - 1 graphs (one padding query): per-query set
    lists inside each query's n bits packed back to back in ``all_sets``,
    the chunk at a random lane of the level, so that its lanes may run past
    the level's end (dead lanes, the padding query, the clamped gather)."""
    rng = np.random.default_rng(seed)
    gs = graphs[: bcap - 1]
    B = len(gs)
    emax = max(8, -(-max(g.m for g in gs) // 8) * 8)
    m = np.zeros(bcap, np.int32)
    emu = np.zeros((bcap, emax), np.int32)
    emv = np.zeros((bcap, emax), np.int32)
    adj = np.zeros((bcap, nmax), np.int32)
    for q, g in enumerate(gs):
        m[q] = g.m
        adj[q] = adj_table(g, nmax).cpu().numpy()
        for j, (u, v) in enumerate(g.edges):
            emu[q, j], emv[q, j] = 1 << u, 1 << v
    ns = rng.integers(1, 2000, B)
    all_sets = np.concatenate([rng.integers(1, 1 << g.n, c)
                               for g, c in zip(gs, ns)]).astype(np.int32)
    soff = np.zeros(B + 1, np.int64)
    np.cumsum(ns, out=soff[1:])
    loff = np.zeros(bcap, np.int32)
    loff[:B] = soff[:B]
    spad = np.full(bcap, soff[B], np.int32)
    spad[:B] = soff[:B]
    eoff = np.zeros(B + 1, np.int64)
    np.cumsum(ns * m[:B], out=eoff[1:])
    lane0 = int(rng.integers(0, eoff[-1]))
    epad = np.full(bcap + 1, eoff[B] - lane0, np.int32)
    epad[: B + 1] = eoff - lane0
    p0 = min(max(int(np.searchsorted(eoff, lane0, side="right")) - 1, 0), B - 1)
    seg0 = int(soff[p0] + (lane0 - eoff[p0]) // m[p0])
    card = [torch.from_numpy(a).to(DEV) for a in
            (all_sets, epad, loff, spad, m, emu, emv, adj)]
    return (*card[:4], seg0, *card[4:], nmax, chunk + 2, chunk)


def dpsub_decode_inputs(graphs, bcap: int, nmax: int, chunk: int, seed: int,
                        head: bool):
    """bccp_eval_decode arguments laid out as ``BatchEngine._eval_dispatch``
    lays them out, over bcap - 1 graphs (one padding query) at a random
    level i: per-query set lists inside each query's n bits back to back in
    ``all_sets``, lanes ``sets x 2^i``.  ``head``: the chunk at lane 0, the
    first query's base moved below 0 (the gather clamps at 0) and seg0 up
    by 3 (segments clamp at 0); else the chunk in the level's last half
    chunk, so that it runs past the level's end (dead lanes, the padding
    query) where it is longer than one lane, and the last query's base
    moved so that its last sets lie past the end of ``all_sets`` (the
    gather clamps at the end)."""
    rng = np.random.default_rng(seed)
    gs = graphs[: bcap - 1]
    B = len(gs)
    i = int(rng.integers(2, nmax + 1))
    adj = np.zeros((bcap, nmax), np.int32)
    for q, g in enumerate(gs):
        adj[q] = adj_table(g, nmax).cpu().numpy()
    ns = rng.integers(1, 2000, B)
    all_sets = np.concatenate([rng.integers(1, 1 << g.n, c)
                               for g, c in zip(gs, ns)]).astype(np.int32)
    soff = np.zeros(B + 1, np.int64)
    np.cumsum(ns, out=soff[1:])
    loff = np.zeros(bcap, np.int32)
    loff[:B] = soff[:B]
    spad = np.full(bcap, soff[B], np.int32)
    spad[:B] = soff[:B]
    eoff = soff << i
    if head:
        loff[0] = -(ns[0] // 2) - 1
        lane0 = 0
    else:
        loff[B - 1] = len(all_sets) - ns[B - 1] // 2 + 1
        lane0 = int(rng.integers(max(0, eoff[-1] - max(chunk // 2, 1)),
                                 eoff[-1]))
    epad = chunks._offset_rows(eoff, np.array([lane0]), bcap)[0]
    p0 = min(max(int(np.searchsorted(eoff, lane0, side="right")) - 1, 0), B - 1)
    seg0 = int(soff[p0] + ((lane0 - eoff[p0]) >> i)) + 3 * head
    card = [torch.from_numpy(a).to(DEV) for a in (all_sets, epad, loff, spad,
                                                  adj)]
    return (*card[:4], seg0, i, card[4], nmax, chunk + 2, chunk)


def solo_tree_inputs(g, nmax: int, chunk: int, seed: int):
    """btree_eval_decode arguments on the one-row tables of the solo tree
    evaluate (``engine._tree_offsets``): 4096 sets inside the query's n
    bits, a random level offset, set, edge and live count."""
    rng = np.random.default_rng(seed)
    offs = engine._tree_offsets(int(rng.integers(0, 4096)),
                                int(rng.integers(0, 1024)),
                                int(rng.integers(0, g.m)),
                                int(rng.integers(0, chunk + 1)))
    emax = max(8, -(-g.m // 8) * 8)
    emu = np.zeros((1, emax), np.int32)
    emv = np.zeros((1, emax), np.int32)
    for j, (u, v) in enumerate(g.edges):
        emu[0, j], emv[0, j] = 1 << u, 1 << v
    card = [torch.from_numpy(np.ascontiguousarray(a)).to(DEV) for a in
            (rng.integers(1, 1 << g.n, 4096).astype(np.int32), offs[0:2],
             offs[2:3], offs[3:4], np.array([g.m], np.int32), emu, emv)]
    return (*card[:4], 0, *card[4:], adj_table(g, nmax)[None].contiguous(),
            nmax, chunk + 1, chunk)


def pair_inputs(ns, adj, nmax: int, chunk: int, seed: int, clamp: bool):
    """bgeneral_eval_decode arguments laid out as the engines' general
    dispatch lays them out (``chunks._pair_table``) over queries of ``ns``
    relations: per query up to 600 random (set, block) pairs sorted by set
    (blocks subsets of their set with two members or more), the chunk at a
    random lane of the level (for chunk 32767 in the level's last half
    chunk, so that its lanes run past the level's end: dead lanes, ranks
    past their block).  ``clamp``: the offsets
    shifted up (p clamps to 0, negative ranks) and ``n_pairs`` cut to half
    the pairs that start inside the chunk (p clamps to n_pairs - 1)."""
    rng = np.random.default_rng(seed)
    ps, pb, pq = [], [], []
    for q, n in enumerate(ns):
        S = rng.integers(1, 1 << n, 4000)
        blk = S & rng.integers(1, 1 << n, 4000)
        keep = np.flatnonzero(bs.np_popcount(blk) >= 2)[: rng.integers(1, 600)]
        order = np.argsort(S[keep], kind="stable")
        ps.append(S[keep][order])
        pb.append(blk[keep][order])
        pq.append(np.full(len(keep), q))
    ps, pb, pq = (np.concatenate(x).astype(np.int32) for x in (ps, pb, pq))
    offs = np.zeros(len(ps) + 1, np.int64)
    np.cumsum(np.int64(1) << bs.np_popcount(pb).astype(np.int64), out=offs[1:])
    tail = chunk == L_MAIN - 1
    lane0 = int(rng.integers(max(0, offs[-1] - chunk // 2) if tail else 0,
                             offs[-1]))
    lane1 = min(lane0 + chunk, int(offs[-1]))
    p0 = int(np.searchsorted(offs, lane0, side="right")) - 1
    p1 = int(np.searchsorted(offs, lane1, side="left"))
    pairs = chunks._pair_table(ps, pb, pq, offs, p0, p1, lane0)
    n_pairs = p1 - p0
    if clamp:
        pairs[3, :n_pairs] += np.int32(rng.integers(1, chunk // 2 + 2))
        n_pairs = max(1, int((pairs[3, :n_pairs] < chunk).sum()) // 2)
    return (torch.from_numpy(pairs).to(DEV), n_pairs, lane1 - lane0, adj,
            nmax, chunk)


def general_inputs(graphs, bcap: int, nmax: int, chunk: int, seed: int,
                   clamp: bool):
    """``pair_inputs`` over bcap - 1 graphs (one padding query)."""
    gs = graphs[: bcap - 1]
    adj = torch.zeros((bcap, nmax), dtype=torch.int32, device=DEV)
    for q, g in enumerate(gs):
        adj[q] = adj_table(g, nmax)
    return pair_inputs([g.n for g in gs], adj, nmax, chunk, seed, clamp)


def solo_general_inputs(g, nmax: int, chunk: int, seed: int, clamp: bool):
    """``pair_inputs`` on the one-row table of the solo general
    evaluate."""
    return pair_inputs([g.n], adj_table(g, nmax)[None].contiguous(), nmax,
                       chunk, seed, clamp)


def phase_a_inputs(g, nmax: int, N: int, seed: int):
    """phase_a_blocks arguments on the card: N random subsets of g's
    vertices (disconnected ones and 0 among them), g's tables, the
    ``eff_cap`` of ``np_pairs_for_sets`` (``CYC_CAP_HARD`` past it) and
    the widest row."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, 1 << g.n, N).astype(np.int32)
    emax = max(8, -(-g.m // 8) * 8)
    eu = np.full(emax, -1, np.int32)
    ev = np.full(emax, -1, np.int32)
    live = np.zeros(emax, bool)
    for i, (u, v) in enumerate(g.edges):
        eu[i], ev[i], live[i] = u, v, True
    eff = max(1, min(ops.CYC_CAP_HARD, g.m - g.n + 1))
    return (torch.from_numpy(S).to(DEV), adj_table(g, nmax),
            *[torch.from_numpy(a).to(DEV) for a in (eu, ev, live)], nmax, eff,
            eff + nmax)


def spied_calls(names, run, where: str):
    """Call ``run()`` with the wrappers ``names`` held against their plain
    versions on every call; return the arguments of each call by name."""
    real = {k: getattr(ops, k) for k in names}
    seen = {k: [] for k in names}

    def spy(name):
        def launch(*args, **kw):
            check(name, args, f"{where} call", fn=real[name])
            seen[name].append(args)
            return real[name](*args, **kw)
        return launch

    try:
        for k in names:
            setattr(ops, k, spy(k))
        run()
    finally:
        for k in names:
            setattr(ops, k, real[k])
    return seen


def busiest_general(calls):
    """The bgeneral_eval_decode call with the most live lanes."""
    return max(calls, key=lambda a: a[2])


def busiest_tree(calls):
    """The btree_eval_prune (or _decode) call with the most live lanes."""
    return max(calls, key=lambda a: min(int(a[1][-1]), a[-1]))


def decode_args(args):
    """A fused form's call -> its decode form's call: the memo tables
    (after ``adj_b``) left out."""
    at = 9 if len(args) == 14 else 4
    return (*args[:at], *args[at + 2:])


def busiest_stream_calls(graphs):
    """Run ``optimize_many(graphs, "auto")`` once with the batched forms
    it runs held against their plain versions on every call; return the
    arguments of the busiest ``bconnectivity_span`` call (most ranks),
    ``btree_eval_prune`` call and ``bgeneral_eval_prune`` call (most live
    lanes)."""
    seen = spied_calls(("bconnectivity_span",) + FUSED_FORMS
                       + ("phase_a_blocks",),
                       lambda: batch.optimize_many(graphs, "auto"), "stream (a)")
    return (max(seen["bconnectivity_span"], key=lambda a: a[2]),
            busiest_tree(seen["btree_eval_prune"]),
            busiest_general(seen["bgeneral_eval_prune"]), seen)


def busiest_dpsub_calls(graphs):
    """Run ``optimize_many(graphs, "dpsub")`` once with its
    ``bccp_eval_decode`` calls held against the plain version on every
    call; return the arguments of the busiest call (most live lanes) and of
    every call."""
    calls = spied_calls(("bccp_eval_decode",),
                        lambda: batch.optimize_many(graphs, "dpsub"),
                        "stream (b)")["bccp_eval_decode"]
    return max(calls, key=lambda a: min(int(a[1][-1]), a[-1])), calls


def lane_args(name, lanes, adj, nmax):
    return (*[lanes[k] for k in KERNELS[name][0]], adj, nmax)


def call(name, args, plain=False, fn=None):
    fn = fn or (getattr(ref, f"{name}_ref") if plain else getattr(ops, name))
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
    elif name == "bgeneral_eval_decode":            # ccp only on live lanes
        blk = lanes["block"]
        lb = bs.pdep(lanes["r"], blk, nmax)
        rb = blk & ~lb
        steps = (pc(blk & nm) + lanes["live"] * ccp_steps(lb, rb)
                 + reach(lb, S & ~rb, adjq))
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


def check(name, args, where: str, fn=None) -> int:
    """Kernel vs plain version on the same card tensors, bit for bit."""
    got = call(name, args, fn=fn)
    want = call(name, args, plain=True)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              if a.numel() else 0 for a, b in zip(got, want))
    dtype = torch.int64 if name in FUSED_FORMS else torch.int32
    if err != 0 or any(a.dtype != dtype for a in got):
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


def search_steps(bcap: int) -> int:
    """Iterations of the binary search over bcap + 1 offsets."""
    return (bcap + 1).bit_length()


def bspan_work(args):
    """(bytes, int32 operations) of a bconnectivity_span call: S, conn and
    qid written, the tables read; per lane the binary search and the
    unrank steps (bit nmax - 1 down to S's lowest bit), and on live lanes
    the connectivity walk."""
    k, foff, count, binom, adj_b, nmax = args
    S, _, qid = call("bconnectivity_span", args, plain=True)
    live = torch.arange(count, device=DEV) < foff[-1]
    tz = bs.popcount(bs.lsb(S) - 1)
    steps = torch.where(S != 0, nmax - tz, 0)
    nbytes = 12 * count + 4 * (foff.numel() + binom.numel() + adj_b.numel())
    walk = op_count("bconnectivity", {"S": S[live], "qid": qid[live]}, adj_b,
                    nmax)
    return nbytes, (int(steps.to(torch.int64).sum()) * UNRANK_OPS_PER_STEP
                    + SEARCH_OPS * search_steps(adj_b.shape[0]) * count
                    + OPS_PER_LANE * int((~live).sum()) + walk)


def tree_decode_work(args):
    """(bytes, int32 operations) of a btree_eval_decode call: five lane
    outputs written, each distinct ``all_sets`` entry and the tables read;
    per lane the binary search, the decode and the btree_eval walk."""
    all_sets, eoff, loff, soff, seg0, m_b, emu_b, emv_b, adj_b, nmax, nseg, \
        chunk = args
    S, _, _, qid, _ = call("btree_eval_decode", args, plain=True)
    t = torch.arange(chunk, dtype=torch.int32, device=DEV)
    local = t - eoff[qid]
    mq = m_b[qid].clamp(min=1)
    e = torch.remainder(local, mq).clamp(0, emu_b.shape[1] - 1)
    idx = (loff[qid] + torch.div(local, mq, rounding_mode="floor")).clamp(
        0, all_sets.numel() - 1)
    lanes = {"S": S, "ub": emu_b[qid, e], "vb": emv_b[qid, e], "qid": qid}
    tables = sum(x.numel() for x in (eoff, loff, soff, m_b, emu_b, emv_b, adj_b))
    nbytes = 20 * chunk + 4 * (torch.unique(idx).numel() + tables)
    return nbytes, (op_count("btree_eval", lanes, adj_b, nmax)
                    + (TREE_DECODE_OPS + SEARCH_OPS * search_steps(
                        adj_b.shape[0])) * chunk)


def dpsub_decode_work(args):
    """(bytes, int32 operations) of a bccp_eval_decode call: five lane
    outputs written, each distinct ``all_sets`` entry and the tables read;
    per lane the binary search, the decode and the pdep walk, and on live
    lanes the ccp test."""
    all_sets, eoff, loff, soff, seg0, i, adj_b, nmax, nseg, chunk = args
    lb, rb, _, qid, _ = call("bccp_eval_decode", args, plain=True)
    t = torch.arange(chunk, dtype=torch.int32, device=DEV)
    live = t < eoff[-1]
    local = t - eoff[qid]
    idx = (loff[qid] + (local >> i)).clamp(0, all_sets.numel() - 1)
    S = lb | rb
    lanes = {"S": S[live], "sub": (local & ((1 << i) - 1))[live],
             "qid": qid[live]}
    tables = sum(x.numel() for x in (eoff, loff, soff, adj_b))
    nbytes = 20 * chunk + 4 * (torch.unique(idx).numel() + tables)
    dead = int((~live).sum())
    pdep_dead = int(bs.popcount(S[~live] & ((1 << nmax) - 1)).to(
        torch.int64).sum())
    return nbytes, (op_count("bccp_eval", lanes, adj_b, nmax)
                    + OPS_PER_STEP * pdep_dead + OPS_PER_LANE * dead
                    + (BDPSUB_DECODE_OPS + SEARCH_OPS * search_steps(
                        adj_b.shape[0])) * chunk)


def general_decode_work(args):
    """(bytes, int32 operations) of a bgeneral_eval_decode call: six lane
    outputs written, the pair table and the adjacency stack read; per lane
    the binary search over the pair offsets, the decode and the walks
    (pdep over the block, the ccp test on live lanes, the grow)."""
    pairs, n_pairs, lane_count, adj_b, nmax, chunk = args
    S, _, _, _, qid, p = call("bgeneral_eval_decode", args, plain=True)
    t = torch.arange(chunk, dtype=torch.int32, device=DEV)
    lanes = {"S": S, "qid": qid, "block": pairs[1][p], "r": t - pairs[3][p],
             "live": (t < lane_count).to(torch.int32)}
    nbytes = 24 * chunk + 4 * (pairs.numel() + adj_b.numel())
    return nbytes, (op_count("bgeneral_eval_decode", lanes, adj_b, nmax)
                    + SEARCH_OPS * search_steps(pairs.shape[1] - 1) * chunk)


def phase_a_work(args):
    """(bytes, int32 operations) of a phase_a_blocks call: the sets read
    and the rows written once, the tables read once; per set OPS_PER_LANE
    and OPS_PER_STEP for each vertex of S the BFS reaches (twice: its
    neighbour OR and its parent pick), each edge the scan reads and each
    vertex the bridge pass visits.  The cycle walks and merges (a few steps
    a set at the queries' cyclomatic numbers of 1-4) are left out, so the
    bound is a floor."""
    S, adj, eu, ev, live, nmax, eff_cap, width = args
    N, emax = S.numel(), eu.numel()
    nbytes = 4 * N * (1 + width) + 4 * (nmax + 2 * emax) + emax
    reach = int(bs.popcount(S & ((1 << nmax) - 1)).to(torch.int64).sum())
    return nbytes, (OPS_PER_STEP * (2 * reach + N * (emax + nmax))
                    + OPS_PER_LANE * N)


def d1_general_calls():
    """Run d1 once with its ``bgeneral_eval_prune`` and ``phase_a_blocks``
    calls held against the plain versions; return the calls' arguments by
    name."""
    label, g, algorithm, opts, _ = solo_parts()[0]
    return spied_calls(("bgeneral_eval_prune", "phase_a_blocks"),
                       lambda: engine.optimize(g, algorithm, **opts), label)


def phase_a_levels(label: str, g, run):
    """Run ``run()`` with its ``phase_a_blocks`` calls held against the
    plain version; check one call a level of g (levels 2..n) and return
    the calls' arguments."""
    calls = spied_calls(("phase_a_blocks",), run, label)["phase_a_blocks"]
    if len(calls) != g.n - 1:
        raise AssertionError(f"{label}: {len(calls)} phase_a_blocks calls "
                             f"for {g.n - 1} levels")
    return calls


MEMO_INDEX_OPS = 11  # a ccp lane's memo indices: S & ~S_left, the query's
                     # base, three ORs, three two-sided clamps
COST_FLOPS = 32      # a ccp lane's cost.join_cost and its two adds: 10 adds,
                     # 8 multiplies, 10 min/max, 4 exp2f (C_TUP * rows once)
REDUCE_OPS = 4       # a live lane's 64-bit compare-and-select into its
                     # segment's minimum (two int32 ops) and its two counts
MEMO_CAP = 1 << 20   # made-up memo tables: larger indices clamp into them


def with_memo(args, seed: int, tie: bool = False):
    """A decode form's arguments -> its fused form's: memo tables of
    ``min(bcap << nmax, MEMO_CAP)`` entries inserted after ``adj_b``,
    random costs (one in ten INF) and log2 rows, or with ``tie`` every
    entry alike (each segment's splits tie)."""
    at = 9 if len(args) == 12 else 4
    adj_b, nmax = args[at - 1], args[at]
    size = min(adj_b.shape[0] << nmax, MEMO_CAP)
    if tie:
        cost = torch.full((size,), 1000.0, device=DEV)
        rows = torch.full((size,), 20.0, device=DEV)
    else:
        g = torch.Generator(device=DEV).manual_seed(seed)
        cost = 1.0 + 1e6 * torch.rand(size, generator=g, device=DEV)
        cost[torch.rand(size, generator=g, device=DEV) < 0.1] = float("inf")
        rows = 60.0 * torch.rand(size, generator=g, device=DEV)
    return (*args[:at], cost, rows, *args[at:])


def memo_of(args):
    """A fused form's memo tables (after ``adj_b``)."""
    at = 9 if len(args) == 14 else 4
    return args[at], args[at + 1]


def torch_epilogue(name, args):
    """What a chunk body ran before its fused form: the decode kernel, then
    the epilogue in torch ops (``ref.tree_epilogue``,
    ``ref.general_epilogue``), packed as the fused form packs it."""
    d = decode_args(args)
    cost, rows = memo_of(args)
    if name == "btree_eval_prune":
        return ref.tree_epilogue(ops.btree_eval_decode(*d), d[8], cost, rows,
                                 d[9], d[10])
    return ref.general_epilogue(ops.bgeneral_eval_decode(*d), d[0].shape[1],
                                d[3], cost, rows, d[4])


def prune_work(name, args):
    """(bytes, int32 operations, float operations) of a fused form's call,
    *assumed*: its decode form's walks and table reads, without the lane
    outputs; on each ccp lane MEMO_INDEX_OPS and COST_FLOPS, and each
    distinct memo entry the ccp lanes read, read once; REDUCE_OPS a live
    lane; one 8-byte key a segment and two 8-byte counts a query written
    once."""
    d = decode_args(args)
    cost, rows = memo_of(args)
    if name == "btree_eval_prune":
        nbytes, n_ops = tree_decode_work(d)
        S, S_left, ccp_i, qid, _ = call("btree_eval_decode", d, plain=True)
        nbytes -= 20 * d[-1]
        nseg, bcap, nmax = d[-2], d[8].shape[0], d[9]
        live = min(int(d[1][-1]), d[-1])
    else:
        nbytes, n_ops = general_decode_work(d)
        S, S_left, _, ccp_i, qid, _ = call("bgeneral_eval_decode", d,
                                           plain=True)
        nbytes -= 24 * d[-1]
        nseg, bcap, nmax = d[0].shape[1], d[3].shape[0], d[4]
        live = d[2]
    on = ccp_i != 0
    base = qid[on] << nmax
    sides = torch.cat([base | S_left[on], base | (S & ~S_left)[on]])
    n_cost = torch.unique(sides.clamp(0, cost.numel() - 1)).numel()
    n_rows = torch.unique(torch.cat([sides, base | S[on]]).clamp(
        0, rows.numel() - 1)).numel()
    ccp = int(on.sum())
    return (nbytes + 4 * (n_cost + n_rows) + 8 * (nseg + 2 * bcap),
            n_ops + MEMO_INDEX_OPS * ccp + REDUCE_OPS * live,
            COST_FLOPS * ccp)


def host_us(fn, reps: int = 50) -> float:
    """Host and card time per call of ``fn`` back to back, in us."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def busiest_fused(label, graphs):
    """Run ``optimize_many(graphs, "auto")`` with the fused forms held
    against their plain versions on every call; return the busiest call of
    each that ran."""
    seen = spied_calls(FUSED_FORMS,
                       lambda: batch.optimize_many(graphs, "auto"), label)
    pick = {"btree_eval_prune": busiest_tree,
            "bgeneral_eval_prune": busiest_general}
    return {k: pick[k](c) for k, c in seen.items() if c}


def time_fused(name, args, row: dict, at: str) -> None:
    """Time a fused form's call (card us a launch, the bound of
    ``prune_work``, its plain version) beside the torch epilogue it
    replaced, on the card and on the host with the fetch, and check the
    two bit for bit; the fused form's numbers into row."""
    bcap = args[8 if name == "btree_eval_prune" else 3].shape[0]
    old = torch_epilogue(name, args)
    new = call(name, args)[0]
    torch.cuda.synchronize()
    if not torch.equal(old, new):
        raise AssertionError(f"{name} disagrees with the torch epilogue at "
                             f"{at}")
    measure(name, args, row, prune_work(name, args))
    row["epilogue_ms"] = event_ms(lambda: torch_epilogue(name, args), 20)
    row["host_us"] = host_us(lambda: chunks._fetch(chunks.Pruned(
        call(name, args)[0], bcap)))
    row["epilogue_host_us"] = host_us(lambda: chunks._fetch(chunks.Pruned(
        torch_epilogue(name, args), bcap)))
    log_row(name, row, at)
    log(f"kernel {name}: the decode kernel and torch epilogue it replaced "
        f"{row['epilogue_ms'] * 1e3:.2f} us on the card; a chunk with its "
        f"fetch {row['host_us']:.1f} us on the host, "
        f"{row['epilogue_host_us']:.1f} us before, at {at}")
    level_fold(name, args, row, at)


def level_fold(name, args, row: dict, at: str) -> None:
    """The chunk in the level-buffer form (``chunks.DeviceFold``): its call
    into a level's key buffer and a flight's counts, timed on the card (us
    a launch) and on the host (a chunk without a fetch), and the level's
    commit (``ops.commit_keys``) beside the host fold it replaced
    (``ChunkResults``: the fetch, the merge and the memo scatter), each on
    scratch memo tables.  The memo the two commits write and the counts
    are held bit for bit against each other; the keys are the chunk's
    segments (tree: one a set) or its pairs, keyed by their (query, set)
    (general: the pairs of one set consecutive)."""
    tree = name == "btree_eval_prune"
    bcap = args[8 if tree else 3].shape[0]
    nmax = args[11 if tree else 6]
    if tree:
        nkeys = args[12]
        idx = np.arange(nkeys, dtype=np.int64)
        key0, pk, sets = 0, None, idx
    else:
        table = args[0].cpu().numpy().astype(np.int64)
        nkeys = int(args[1])
        idx = (table[2, :nkeys] << nmax) | table[0, :nkeys]
        head = np.r_[True, idx[1:] != idx[:-1]]
        key0, pk, sets = (0, nkeys), np.cumsum(head) - 1, idx[head]
    size = bcap << nmax
    slack = nkeys if tree else args[0].shape[1]

    def memo():
        return (torch.full((size,), float("inf"), device=DEV),
                torch.zeros(size, dtype=torch.int32, device=DEV))

    def host_fold(cost, left):
        acc = chunks.ChunkResults(len(sets), bcap, pk, idx=sets)
        acc.add(key0, chunks.Pruned(call(name, args)[0], bcap))
        return acc.commit(cost, left)

    def device_fold(cost, left):
        fold = chunks.DeviceFold(bcap, DEV).level(idx, slack)
        fold.add(key0, chunks.Pruned(getattr(ops, name)(
            *args, **fold.into(0)), bcap))
        counts = fold.counts
        fold.commit(cost, left)
        return counts

    hc, hl = memo()
    ev, ccp = host_fold(hc, hl)
    dc, dl = memo()
    counts = device_fold(dc, dl).cpu().numpy()
    torch.cuda.synchronize()
    if not (torch.equal(hc.view(torch.int32), dc.view(torch.int32))
            and torch.equal(hl, dl) and np.array_equal(counts[:bcap], ev)
            and np.array_equal(counts[bcap:], ccp)):
        raise AssertionError(f"{name}: the device fold disagrees with the "
                             f"host fold at {at}")
    keys = torch.zeros(nkeys + slack, dtype=torch.int64, device=DEV)
    cnt = torch.zeros(2 * bcap, dtype=torch.int64, device=DEV)
    idx_d = torch.from_numpy(idx.astype(np.int32)).to(DEV)

    def launch():
        return getattr(ops, name)(*args, keys=keys, counts=cnt)
    row["fold_ms"] = event_ms(launch, 100)
    row["fold_host_us"] = host_us(launch)
    row["commit_ms"] = event_ms(lambda: ops.commit_keys(keys, idx_d, dc, dl),
                                100)
    row["commit_host_us"] = host_us(lambda: device_fold(dc, dl))
    row["host_fold_us"] = host_us(lambda: host_fold(hc, hl))
    log(f"kernel {name}: level-buffer form {row['fold_ms'] * 1e3:.2f} "
        f"us/launch on the card, a chunk {row['fold_host_us']:.1f} us on the "
        f"host without a fetch ({row['host_us']:.1f} us with it); the "
        f"level's commit {row['commit_ms'] * 1e3:.2f} us on the card, a "
        f"one-chunk level folded and committed {row['commit_host_us']:.1f} us "
        f"on the host, {row['host_fold_us']:.1f} us by the host fold; device "
        f"fold == host fold bit for bit ({len(sets)} sets, {nkeys} keys) at "
        f"{at}")


def phase_fused(rows, tree_p, general_p) -> None:
    """The fused evaluate epilogue at the benchmark cells' shapes: the
    busiest chunk of a clique of 15 (its largest level; the JSON row of
    bgeneral_eval_prune), of musicbrainz_query(16, 1) and of
    snowflake(16, 1) (the JSON row of btree_eval_prune), each query alone
    in its flight as the daemon runs it, every call of the three runs held
    against the plain version; and stream (a)'s busiest chunks."""
    clique = busiest_fused("clique 15", [gen.clique(15, 1)])
    mb16 = busiest_fused("musicbrainz 16", [gen.musicbrainz_query(16, 1)])
    sf16 = busiest_fused("snowflake 16", [gen.snowflake(16, 1)])
    for name, args, row, at in (
            ("bgeneral_eval_prune", clique["bgeneral_eval_prune"],
             rows["bgeneral_eval_prune"], "clique(15, 1)"),
            ("bgeneral_eval_prune", mb16["bgeneral_eval_prune"], {},
             "musicbrainz_query(16, 1)"),
            ("btree_eval_prune", sf16["btree_eval_prune"],
             rows["btree_eval_prune"], "snowflake(16, 1)"),
            ("btree_eval_prune", tree_p, {}, "stream (a)"),
            ("bgeneral_eval_prune", general_p, {}, "stream (a)")):
        live = args[2] if name == "bgeneral_eval_prune" else \
            min(int(args[1][-1]), args[-1])
        row["at"] = (f"L={args[-1]} live={live} nmax=16 bcap="
                     f"{args[8 if name == 'btree_eval_prune' else 3].shape[0]}"
                     f" ({at}'s busiest chunk)")
        time_fused(name, args, row, row["at"])
    log("fused kernels ok on every chunk of clique(15, 1), "
        "musicbrainz_query(16, 1) and snowflake(16, 1); device fold == host "
        "fold at each timed chunk")


def measure(name, args, row: dict, work) -> None:
    """Card time per launch, plain-version time and the bound of
    ``work = (bytes, int32 operations[, float operations])``, into row:
    the operations' time is the INT32 pipe's or, with float operations,
    that of dispatching all of them, whichever is longer."""
    nbytes, ops_n, *flops = work
    flops = sum(flops)
    ms = event_ms(lambda: call(name, args), 100)
    plain_ms = event_ms(lambda: call(name, args, plain=True), 10)
    t_b = nbytes / roofline.HBM_BW * 1e3
    t_o = max(ops_n / INT32_OPS_S, (ops_n + flops) / FP32_OPS_S) * 1e3
    row.update(ms=ms, plain_ms=plain_ms, bytes=nbytes, int32_ops=ops_n,
               float_ops=flops,
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
                seed = nmax * 1000 + bcap * 10 + L
                for name, args, work in (
                        ("bconnectivity_span",
                         bspan_inputs(graphs, bcap, nmax, L, seed), bspan_work),
                        ("bccp_eval_decode",
                         dpsub_decode_inputs(graphs, bcap, nmax, L, seed,
                                             False), dpsub_decode_work),
                        ("bccp_eval_decode",
                         dpsub_decode_inputs(graphs, bcap, nmax, L, seed + 1,
                                             True), None),
                        ("btree_eval_decode",
                         tree_inputs(graphs, bcap, nmax, L, seed),
                         tree_decode_work),
                        ("bgeneral_eval_decode",
                         general_inputs(graphs, bcap, nmax, L, seed, False),
                         general_decode_work),
                        ("bgeneral_eval_decode",
                         general_inputs(graphs, bcap, nmax, L, seed + 1, True),
                         None),
                        ("btree_eval_prune", with_memo(
                            tree_inputs(graphs, bcap, nmax, L, seed), seed),
                         None),
                        ("bgeneral_eval_prune", with_memo(
                            general_inputs(graphs, bcap, nmax, L, seed, False),
                            seed), None),
                        ("bgeneral_eval_prune", with_memo(
                            general_inputs(graphs, bcap, nmax, L, seed + 1,
                                           True), seed + 1, tie=True), None)):
                    err = check(name, args, f"nmax={nmax} bcap={bcap} L={L} "
                                f"(lanes built in the kernel)")
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
                    if (nmax, bcap, L) == (16, 32, L_MAIN) and work:
                        at_l = {}
                        measure(name, args, at_l, work(args))
                        log_row(name, at_l, f"L={L} nmax=16 bcap=32 (random "
                                f"level k={args[0]})" if name == "bconnectivity_span"
                                else f"L={L} live={args[2]} nmax=16 bcap=32 "
                                f"(random pairs)" if name == "bgeneral_eval_decode"
                                else f"L={L} i={args[5]} nmax=16 bcap=32 "
                                f"(random sets)" if name == "bccp_eval_decode"
                                else f"L={L} nmax=16 bcap=32 (random sets)")
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
                for name, args in (
                        ("btree_eval_decode",
                         solo_tree_inputs(g, nmax, L, seed=L + nmax + gi)),
                        ("bgeneral_eval_decode",
                         solo_general_inputs(g, nmax, L, L + nmax + gi, False)),
                        ("bgeneral_eval_decode",
                         solo_general_inputs(g, nmax, L, L + nmax + gi + 1,
                                             True)),
                        ("btree_eval_prune", with_memo(
                            solo_tree_inputs(g, nmax, L, seed=L + nmax + gi),
                            L + gi, tie=True)),
                        ("bgeneral_eval_prune", with_memo(
                            solo_general_inputs(g, nmax, L, L + nmax + gi,
                                                False), L + gi))):
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"],
                        check(name, args, f"nmax={nmax} n={g.n} L={L} "
                              f"(one-row tables)"))
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
    span, tree_p, general_p, seen = busiest_stream_calls(
        gen.mixed_stream(32, seed=0, sizes=(12, 13, 14, 15, 16)))
    tree, general = decode_args(tree_p), decode_args(general_p)
    for name, a, work in (("bconnectivity_span", span, bspan_work),
                          ("btree_eval_decode", tree, tree_decode_work),
                          ("bgeneral_eval_decode", general,
                           general_decode_work)):
        measure(name, a, rows[name], work(a))
    log(f"batched kernels ok on stream (a)'s {len(seen['bconnectivity_span'])} "
        f"bconnectivity_span, {len(seen['btree_eval_prune'])} "
        f"btree_eval_prune and {len(seen['bgeneral_eval_prune'])} "
        f"bgeneral_eval_prune calls")
    dpsub, b_calls = busiest_dpsub_calls(stream_b())
    measure("bccp_eval_decode", dpsub, rows["bccp_eval_decode"],
            dpsub_decode_work(dpsub))
    log(f"batched kernels ok on stream (b)'s {len(b_calls)} bccp_eval_decode "
        f"calls")
    d1_seen = d1_general_calls()
    d1_calls = d1_seen["bgeneral_eval_prune"]
    d1_busy = decode_args(busiest_general(d1_calls))
    at_l = {}
    measure("bgeneral_eval_decode", d1_busy, at_l, general_decode_work(d1_busy))
    log_row("bgeneral_eval_decode", at_l,
            f"L={d1_busy[5]} live={d1_busy[2]} pairs={d1_busy[1]} "
            f"pcap={d1_busy[0].shape[1]} nmax=24 one row (d1's busiest chunk)")
    log(f"solo kernels ok on d1's {len(d1_calls)} bgeneral_eval_prune calls")
    phase_a_kernel(rows, seen["phase_a_blocks"], d1_seen["phase_a_blocks"])
    phase_fused(rows, tree_p, general_p)
    at_main = {
        "connectivity_span": "count=5200300 k=12 nmax=30 (d4's level-12 span)",
        "ccp_eval_dpsub": f"L={L_MAIN} nmax=24 i={args[4]} (d3's busiest level)",
        "bconnectivity_span": f"count={span[2]} k={span[0]} nmax=16 "
                              f"bcap={span[4].shape[0]} (stream a's busiest "
                              f"level span)",
        "bccp_eval_decode": f"L={dpsub[-1]} live={min(int(dpsub[1][-1]), dpsub[-1])} "
                            f"i={dpsub[5]} nmax=16 bcap={dpsub[6].shape[0]} "
                            f"(stream b's busiest chunk)",
        "btree_eval_decode": f"L={tree[-1]} live={int(tree[1][-1])} nmax=16 "
                             f"bcap={tree[8].shape[0]} (stream a's busiest "
                             f"tree chunk)",
        "bgeneral_eval_decode": f"L={general[5]} live={general[2]} "
                                f"pairs={general[1]} pcap="
                                f"{general[0].shape[1]} nmax=16 bcap="
                                f"{general[3].shape[0]} (stream a's busiest "
                                f"general chunk)"}
    for name, row in rows.items():
        at = at_main.get(name, row.get("at") or (
            "nmax=24 (one table)" if name in SOLO else "nmax=16 bcap=32"))
        log_row(name, row, at)
    return rows


def phase_a_kernel(rows, a_calls, d1_calls) -> None:
    """phase_a_blocks against its plain version: N random sets (1, 129,
    32767) on every graph of phase 3 at nmax 8, 16 (the 32 of each), 24
    and 30 (the solo ones), at the widest row and at the width
    ``np_pairs_for_sets`` gives; then every level of stream (a) and d1
    (held while they ran) and of l1 (d1 on the lattice, one shard).
    Times: each level of a 16-relation
    musicbrainz query (q12_16's largest) and the largest level of a
    20-relation one (solo18_20's), the latter the JSON row."""
    row = rows["phase_a_blocks"]
    for nmax in (8, 16, 24, 30):
        graphs = kernel_graphs(nmax) if nmax <= 16 else solo_graphs(nmax)
        for gi, g in enumerate(graphs):
            for N in (1, 129, 32767):
                args = phase_a_inputs(g, nmax, N, seed=nmax * 1000 + gi + N)
                for width in (args[-1], args[-2] + g.n - 1):
                    row["max_abs_err"] = max(row["max_abs_err"], check(
                        "phase_a_blocks", (*args[:-1], width),
                        f"nmax={nmax} n={g.n} N={N} width={width}"))
        log(f"phase A kernel ok nmax={nmax} on {len(graphs)} graphs")
    d1g = solo_parts()[0][1]
    l1 = phase_a_levels("l1 d1 x1", d1g, lambda: engine.optimize(
        d1g, config=OptimizerConfig(algorithm="mpdp", lattice=True,
                                    devices=1)))
    log(f"phase A kernel ok on every level of stream (a) ({len(a_calls)} "
        f"calls), d1 ({len(d1_calls)}) and l1 ({len(l1)})")
    q16 = gen.musicbrainz_query(16, seed=1)
    levels = phase_a_levels("q16", q16, lambda: batch.optimize_many(
        [q16], "auto"))
    timed = []
    for args in levels:
        at_l = {}
        measure("phase_a_blocks", args, at_l, phase_a_work(args))
        timed.append((args, at_l))
    busy, at_l = max(timed, key=lambda t: t[0][0].numel())
    log_row("phase_a_blocks", at_l, f"N={busy[0].numel()} width={busy[-1]} "
            f"eff_cap={busy[-2]} nmax=16 (musicbrainz_query(16, 1)'s "
            f"largest level)")
    log(f"kernel phase_a_blocks: "
        f"{sum(t['ms'] for _, t in timed) * 1e3:.2f} us over the "
        f"{len(levels)} levels of musicbrainz_query(16, 1), plain "
        f"{sum(t['plain_ms'] for _, t in timed) * 1e3:.2f} us")
    q20 = gen.musicbrainz_query(20, seed=0)
    levels = phase_a_levels("q20", q20, lambda: engine.optimize(q20, "auto"))
    busy = max(levels, key=lambda a: a[0].numel())
    measure("phase_a_blocks", busy, row, phase_a_work(busy))
    row["at"] = (f"N={busy[0].numel()} width={busy[-1]} eff_cap={busy[-2]} "
                 f"nmax=24 (musicbrainz_query(20, 0)'s largest level)")


def log_row(name, row, at):
    log(f"kernel {name}: {row['ms'] * 1e3:.2f} us/launch, plain "
        f"{row['plain_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.4f} us "
        f"({row['bound_by']}: {row['bytes']} B, {row['int32_ops']} int32 ops"
        + (f", {row['float_ops']} float ops" if row.get('float_ops') else "")
        + f") at {at}")


# ---------------------------------------------------------------- phase 4 --

def rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def ulps(a: float, b: float) -> int:
    ia = np.array([a], np.float32).view(np.int32)[0]
    ib = np.array([b], np.float32).view(np.int32)[0]
    return abs(int(ia) - int(ib))


def flights(graphs, algorithm):
    """How ``optimize_many`` runs ``graphs``: the relation counts of each
    batched flight, and the graphs it sends solo."""
    pending = batch.probe_stream(graphs, [None] * len(graphs), None,
                                 algorithm)
    buckets, solo = batch.bucket_pending(graphs, pending, algorithm)
    out = []
    for idxs in buckets.values():
        for s0 in range(0, len(idxs), MAX_FLIGHT):
            out.append([graphs[q].n for q in idxs[s0: s0 + MAX_FLIGHT]])
    return out, [graphs[q] for q in solo]


def bspan_launches(graphs, algorithm) -> int:
    """``bconnectivity_span`` launches ``optimize_many`` makes: one per
    level span (``engine.SPAN`` ranks) of every batched flight."""
    return sum(-(-sum(comb(n, i) for n in ns) // engine.SPAN)
               for ns in flights(graphs, algorithm)[0]
               for i in range(2, max(ns) + 1))


def span_launches(g) -> int:
    """``connectivity_span`` launches of a solo run over ``g``: one per
    level span."""
    return sum(-(-comb(g.n, i) // engine.SPAN) for i in range(2, g.n + 1))


def check_bspan(label, graphs, algorithm, before) -> None:
    """Raise unless the batched filter made one launch per level and
    flight."""
    got = ops.LAUNCHES["bconnectivity_span"] - before["bconnectivity_span"]
    want = bspan_launches(graphs, algorithm)
    if got != want:
        raise AssertionError(f"{label}: {got} bconnectivity_span launches for "
                             f"{want} levels and flights")


STREAM_LAUNCHES = {}        # phase 4's launches per stream, for phase 10


def run_stream(label, graphs, algorithm, n_cpu):
    """One stream on cuda: timed, validated, held against DPccp and the
    port's CPU run of its first ``n_cpu`` queries."""
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batch.optimize_many(graphs, algorithm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    STREAM_LAUNCHES[label] = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
    log(f"stream {label}: {len(graphs)} queries ({algorithm}) in {wall:.3f} s "
        f"= {len(graphs) / wall:.2f} queries/s on cuda; launches "
        + json.dumps(STREAM_LAUNCHES[label]))
    check_bspan(f"stream {label}", graphs, algorithm, before)
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


class ChunkCalls:
    """Counts, while it is entered, the calls on card tensors of the chunk
    layer's bodies (``chunks._beval_*``) that launch ``bgeneral_eval_decode`` (the MPDP-general ones),
    ``btree_eval_decode`` (the MPDP:Tree ones) and ``bccp_eval_decode``
    (the batched DPSUB one), as the batched, lattice and solo engines
    call them; an MPDP-general or MPDP:Tree call without conflict arrays
    (``targs``) counts under the fused form it launches instead
    (``FUSED_OF``); and under ``phase_a_blocks`` the calls of
    ``blocks.np_pairs_for_sets`` on card tensors that take its sparse path
    (cyclomatic number <= cyc_cap) with sets; the CPU runs that the checks
    make are not counted."""
    BODIES = {"bgeneral_eval_decode": ((chunks, "_beval_general_chunk"),),
              "btree_eval_decode": ((chunks, "_beval_tree_chunk"),),
              "bccp_eval_decode": ((chunks, "_beval_dpsub_chunk"),)}

    def __init__(self):
        self.count = {k: 0 for k in (*self.BODIES, *FUSED_FORMS)}
        self.count["phase_a_blocks"] = 0
        self.real = {(m, n): getattr(m, n) for bodies in self.BODIES.values()
                     for m, n in bodies}
        self.real[(blocks, "np_pairs_for_sets")] = blocks.np_pairs_for_sets

    def __enter__(self):
        def counted(kernel, fn):
            def body(first, *args, **kw):
                fused = kernel in FUSED_OF and not kw.get("targs")
                self.count[FUSED_OF[kernel] if fused else kernel] += \
                    first.is_cuda
                return fn(first, *args, **kw)
            return body
        for kernel, bodies in self.BODIES.items():
            for m, n in bodies:
                setattr(m, n, counted(kernel, self.real[(m, n)]))
        real_pairs = self.real[(blocks, "np_pairs_for_sets")]

        def pairs(sets_np, g, adj, *args, cyc_cap, **kw):
            self.count["phase_a_blocks"] += (adj.is_cuda and len(sets_np) > 0
                                             and g.m - g.n + 1 <= cyc_cap)
            return real_pairs(sets_np, g, adj, *args, cyc_cap=cyc_cap, **kw)
        blocks.np_pairs_for_sets = pairs
        return self

    def __exit__(self, *exc):
        for (m, n), fn in self.real.items():
            setattr(m, n, fn)


def check_path(label: str, launches: dict, path, chunks: dict,
               typed: bool = False) -> None:
    """Raise unless every kernel of the path launched, the set-given
    kernels they replaced did not, nor the tree and general decode forms
    where the path runs no typed query (not ``typed``), the
    MPDP-general and MPDP:Tree evaluates made one ``bgeneral_eval_prune``
    and ``btree_eval_prune`` launch per chunk of an inner-join flight and
    one ``bgeneral_eval_decode`` and ``btree_eval_decode`` launch per
    chunk of a typed one, the batched DPSUB evaluates one
    ``bccp_eval_decode`` launch per chunk, and phase A one
    ``phase_a_blocks`` launch per (query, level) on its sparse path
    (``chunks``: ``ChunkCalls`` counts)."""
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {label} path: "
                             f"{missing}")
    off = {k: launches[k] for k in OFF_PATH if launches[k]}
    if off:
        raise AssertionError(f"set-given kernels launched on the {label} "
                             f"path: {off}")
    kept = {k: chunks[k] for k in FUSED_OF if chunks[k]}
    if kept and not typed:
        raise AssertionError(f"{label} path: chunks of typed flights {kept}")
    for kernel, n in chunks.items():
        if launches[kernel] != n:
            raise AssertionError(f"{label} path: {launches[kernel]} {kernel} "
                                 f"launches for {n} chunk bodies")
    log(f"{label} path: one launch for each chunk body: "
        f"bgeneral_eval_prune {chunks['bgeneral_eval_prune']} and "
        f"bgeneral_eval_decode {chunks['bgeneral_eval_decode']} "
        f"(MPDP-general, inner and typed), btree_eval_prune "
        f"{chunks['btree_eval_prune']} and btree_eval_decode "
        f"{chunks['btree_eval_decode']} (MPDP:Tree), bccp_eval_decode "
        f"{chunks['bccp_eval_decode']} (batched DPSUB), phase_a_blocks "
        f"{chunks['phase_a_blocks']} (sparse phase-A (query, level)s); no "
        f"launch of {', '.join(OFF_PATH)}")


def profile(label: str, fn, names) -> float:
    """Kernel time by name and the card's busy share over one call of fn
    (returned), from the device events alone (``device_events``)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for name, _, a, b in device_events(prof):
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + b - a)
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
    return busy_us / 1e6 / wall


# ---------------------------------------------------------------- phase 5 --

def stream_b():
    return gen.mixed_stream(8, seed=1, sizes=(10, 11, 12, 13))


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


def hold(label, g, r, c=None, oracle_cost=None):
    """Valid plan (conflict rules included), cost within 1e-4 of DPccp
    (``oracle_cost``, or solved here); against the cpu run c: algorithm,
    Counters exact and cost within 1e-5.  Returns the ulps to c."""
    validate_plan(r.plan, g)
    if oracle_cost is None:
        oracle_cost = dpccp.solve(g).cost
    if rel(r.cost, oracle_cost) > 1e-4:
        raise AssertionError(f"{label}: cost {r.cost} vs DPccp {oracle_cost} "
                             f"(n={g.n})")
    if c is None:
        return 0
    if (r.algorithm, r.counters.evaluated, r.counters.ccp) != \
            (c.algorithm, c.counters.evaluated, c.counters.ccp):
        raise AssertionError(f"{label}: {r.algorithm} {r.counters} on cuda vs "
                             f"{c.algorithm} {c.counters} on cpu")
    if rel(r.cost, c.cost) > 1e-5:
        raise AssertionError(f"{label}: cost {r.cost} on cuda vs {c.cost} on cpu")
    return ulps(r.cost, c.cost)


def run_solo(label, g, algorithm, opts, vs_cpu):
    """One solo query on cuda: timed, its stages and launches printed, held
    against DPccp and (vs_cpu) the port's cpu run.  Returns the result."""
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
        spans = span_launches(g)
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
    return r


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
    check_bspan("solo d5 optimize_many", graphs, "auto", before)
    cpu = batch.optimize_many(graphs, "auto", device="cpu")
    worst = max(hold(f"solo d5 optimize_many query {i}", g, r, c)
                for i, (g, r, c) in enumerate(zip(graphs, res, cpu)))
    log(f"solo d5 optimize_many: all plans valid, within 1e-4 of DPccp, match "
        f"the cpu run (counters exact, max {worst} ulp)")


# ---------------------------------------------------------------- phase 6 --

def typed_parts():
    """The typed stream and the two typed solo queries."""
    stream = gen.mixed_joins_stream(16, seed=0, sizes=(12, 13, 14, 15, 16))
    solo = [("mpdp n=20", gen.typed_query(20, seed=11, base="musicbrainz"),
             "mpdp"),
            ("dpsub n=17", gen.typed_query(17, seed=11, base="musicbrainz"),
             "dpsub")]
    return stream, solo


def dpccp_cost(g) -> float:
    """The typed host DPccp's optimal cost (run in a worker process)."""
    return dpccp.solve(g).cost


def timed(fn):
    """(result, wall seconds) of fn() on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_typed():
    """The typed path on cuda, launch counters read around exactly it;
    the typed DPccp oracle runs in worker processes meanwhile.  Returns the
    launches and t20's result."""
    stream, solo = typed_parts()
    t_start = time.perf_counter()
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=6, mp_context=spawn) as pool:
        futs = [pool.submit(dpccp_cost, g)
                for g in stream + [g for _, g, _ in solo]]
        res = {}
        ops.reset_launches()
        with ChunkCalls() as chunks:
            for algorithm in ("auto", "dpsub"):
                before = dict(ops.LAUNCHES)
                res[algorithm], wall = timed(
                    lambda: batch.optimize_many(stream, algorithm))
                log(f"typed stream {algorithm}: {len(stream)} queries in "
                    f"{wall:.3f} s = {len(stream) / wall:.2f} queries/s on "
                    f"cuda; launches " + json.dumps(
                        {k: v - before[k] for k, v in ops.LAUNCHES.items()
                         if v != before[k]}))
                flights = {(r.algorithm, tuple(sorted(r.timings.items())))
                           for r in res[algorithm]}
                for algo, stages in sorted(flights):
                    log(f"typed stream {algorithm}: flight {algo} stage "
                        f"seconds " + json.dumps({k: round(v, 4)
                                                  for k, v in stages}))
                check_bspan(f"typed stream {algorithm}", stream, algorithm,
                            before)
            for label, g, algorithm in solo:
                before = dict(ops.LAUNCHES)
                res[label], wall = timed(lambda: engine.optimize(g, algorithm))
                r = res[label]
                log(f"typed solo {label}: m={g.m} {r.algorithm} in {wall:.3f} "
                    f"s on cuda; counters {r.counters}; stage seconds "
                    + json.dumps({k: round(v, 4) for k, v in r.timings.items()})
                    + "; launches " + json.dumps(
                        {k: v - before[k] for k, v in ops.LAUNCHES.items()
                         if v != before[k]}))
                spans = span_launches(g)
                got = (ops.LAUNCHES["connectivity_span"]
                       - before["connectivity_span"])
                if got != spans:
                    raise AssertionError(f"typed solo {label}: {got} "
                                         f"connectivity_span launches for "
                                         f"{spans} level spans")
        typed = dict(ops.LAUNCHES)
        log(f"typed path: {time.perf_counter() - t_start:.1f} s on cuda; "
            f"launches " + json.dumps(typed))
        check_path("typed", typed, TYPED_PATH, chunks.count, typed=True)
        try:
            engine.optimize(solo[1][1], "dpsize")
        except ValueError as e:
            log(f"typed dpsize refused: {e}")
        else:
            raise AssertionError("dpsize ran on a typed graph")
        costs = [f.result() for f in futs]
    log(f"typed DPccp oracle: {len(costs)} queries, done at "
        f"{time.perf_counter() - t_start:.1f} s (6 worker processes)")
    t1 = time.perf_counter()
    small = [i for i, g in enumerate(stream) if g.n <= 13]
    for algorithm in ("auto", "dpsub"):
        cpu = dict(zip(small, batch.optimize_many(
            [stream[i] for i in small], algorithm, device="cpu")))
        worst = max(hold(f"typed stream {algorithm} query {i}", g, r,
                         cpu.get(i), costs[i])
                    for i, (g, r) in enumerate(zip(stream, res[algorithm])))
        log(f"typed stream {algorithm}: all {len(stream)} plans valid, costs "
            f"within 1e-4 of typed DPccp; the {len(small)} queries of 13 "
            f"relations or fewer match the cpu run (counters exact, max "
            f"{worst} ulp)")
    for (label, g, _), cost in zip(solo, costs[len(stream):]):
        hold(f"typed solo {label}", g, res[label], oracle_cost=cost)
        log(f"typed solo {label}: plan valid, cost within 1e-4 of typed DPccp")
    log(f"typed checks on the host: {time.perf_counter() - t1:.1f} s")
    return typed, res[solo[0][0]]


# ---------------------------------------------------------------- phase 7 --

GOO_EPS = 2e-3        # the reference's margin for "UnionDP <= GOO"
HEURISTICS = {"idp": idp, "uniondp": uniondp}


def heuristic_parts():
    """(label, module, graph, options, hold against the cpu run)."""
    mb56 = gen.musicbrainz_query(56, seed=256)
    snow400 = gen.snowflake(400, seed=7)
    return [
        ("h1 uniondp mb56 k=15", "uniondp", mb56, {"k": 15}, True),
        ("h2 idp2 mb56 k=15", "idp", mb56, {"k": 15}, True),
        ("h3 uniondp snow400 k=15", "uniondp", snow400, {"k": 15}, False),
        ("h3 idp2 snow400 k=15", "idp", snow400, {"k": 15}, False),
        ("h4 idp2 snow80 k=20", "idp", gen.snowflake(80, seed=7), {"k": 20},
         False),
        ("h5 idp2 dpsub mb30 k=12", "idp", gen.musicbrainz_query(30, seed=230),
         {"k": 12, "subsolver": "dpsub"}, True),
        ("h6 uniondp typed mb40 k=15", "uniondp",
         gen.typed_query(40, seed=11, base="musicbrainz"), {"k": 15}, False),
    ]


def plan_shape(p):
    return p.rel_set if p.is_leaf else (plan_shape(p.left), plan_shape(p.right))


def plan_of(s) -> Plan:
    """A plan tree of shape ``s`` (``cost_plan`` fills in its costs)."""
    if isinstance(s, int):
        return Plan(rel_set=s, cost=0.0, rows_log2=0.0)
    left, right = plan_of(s[0]), plan_of(s[1])
    return Plan(rel_set=left.rel_set | right.rel_set, cost=0.0, rows_log2=0.0,
                left=left, right=right)


class SubSolverCalls:
    """Records, while it is entered, every ``engine.optimize_many`` call
    (the heuristics' exact sub-solver): its graphs, its algorithm, the plan
    shapes it returned, its seconds (ended by a synchronize on the card)
    and its flights' stage seconds."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.calls = []

    def __enter__(self):
        real = self.real = engine.optimize_many

        def spy(graphs, *args, **kw):
            t0 = time.perf_counter()
            rs = real(graphs, *args, **kw)
            if self.on_card:
                torch.cuda.synchronize()
            stages = {}
            for st in {tuple(sorted(r.timings.items())) for r in rs}:
                for k, v in st:
                    stages[k] = stages.get(k, 0.0) + v
            self.calls.append((list(graphs), kw["algorithm"],
                               [plan_shape(r.plan) for r in rs],
                               time.perf_counter() - t0, stages))
            return rs
        engine.optimize_many = spy
        return self

    def __exit__(self, *exc):
        engine.optimize_many = self.real


def heuristic_cpu_run(i: int):
    """Part ``i`` of phase 7 on ``device="cpu"`` (in a worker process):
    per sub-solver call its subproblems' wires and the plan shapes, then
    the plan's shape, its cost and the counters."""
    torch.set_num_threads(1)
    _, mod, g, opts, _ = heuristic_parts()[i]
    with SubSolverCalls(on_card=False) as spy:
        r = HEURISTICS[mod].solve(g, device="cpu", **opts)
    return ([([graph_to_wire(x) for x in gs], shapes)
             for gs, _, shapes, _, _ in spy.calls],
            plan_shape(r.plan), r.cost, (r.counters.evaluated, r.counters.ccp))


def hold_against_cpu(label, r, calls, cpu) -> str:
    """Round by round against the cpu run: equal subproblems in, equal plan
    shapes out, then equal plan, cost and counters; a differing shape only
    as a shown tie (both subplans within 1e-5 on that subproblem), after
    which the run is compared no further."""
    cpu_calls, shape, cost, counters = cpu
    for i, ((gs, _, shapes, _, _), (wires, cshapes)) in enumerate(
            zip(calls, cpu_calls)):
        if [graph_to_wire(x) for x in gs] != wires:
            raise AssertionError(f"{label}: call {i} got other subproblems on "
                                 f"cuda than on cpu")
        if shapes == cshapes:
            continue
        for j, (x, a, b) in enumerate(zip(gs, shapes, cshapes)):
            if a == b:
                continue
            ca, cb = (cost_plan(plan_of(s), x).cost for s in (a, b))
            if abs(ca - cb) > 1e-5 * abs(cb):
                raise AssertionError(f"{label}: call {i} subproblem {j}: "
                                     f"cost {ca} on cuda vs {cb} on cpu")
            log(f"{label}: call {i} subproblem {j} (n={x.n}) is a tie broken "
                f"by rounding ({ca!r} on cuda, {cb!r} on cpu); compared no "
                f"further")
        return (f"matches the cpu run up to a shown tie at call {i} (final "
                f"cost {r.cost!r} on cuda, {cost!r} on cpu)")
    if (len(calls), plan_shape(r.plan), r.cost,
            (r.counters.evaluated, r.counters.ccp)) != \
            (len(cpu_calls), shape, cost, counters):
        raise AssertionError(f"{label}: cuda run {r.cost} {r.counters} after "
                             f"{len(calls)} calls, cpu run {cost} {counters} "
                             f"after {len(cpu_calls)}")
    return (f"matches the cpu run ({len(calls)} calls: equal subproblems and "
            f"plan shapes, equal plan, cost == and counters)")


def lattice_spans(n: int, shards: int) -> int:
    """``bconnectivity_span`` launches of a lattice run of an n-relation
    query on ``shards`` shards: per level one a shard with ranks."""
    return sum(-(-int(x) // engine.SPAN) for i in range(2, n + 1)
               for x in np.diff(partition_lanes(comb(n, i), shards)))


def run_heuristic(label, mod, g, opts, shards=None):
    """One heuristic part on cuda: timed, validated, its sub-solver calls,
    flights and launches checked and printed; with a mesh of ``shards``
    shards in ``opts`` the subproblems past a batched flight run on the
    lattice instead of solo.  Returns (result, calls)."""
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SubSolverCalls(on_card=True) as spy:
        r = HEURISTICS[mod].solve(g, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = spy.calls
    launches = {k: v - before[k] for k, v in ops.LAUNCHES.items()
                if v != before[k]}
    runs = [flights(gs, algo) for gs, algo, _, _, _ in calls]
    inside = sum(c[3] for c in calls)
    stages = {}
    for c in calls:
        for k, v in c[4].items():
            stages[k] = stages.get(k, 0.0) + v
    latt = []
    if shards is not None:              # the mesh's lattice takes these
        latt = [x for (_, solo), (_, algo, _, _, _) in zip(runs, calls)
                for x in solo if x.n <= lattice.NMAX_LATTICE
                and batch._lane_space(x, algo) is not None]
        ids = {id(x) for x in latt}
        runs = [(f, [x for x in solo if id(x) not in ids]) for f, solo in runs]
    log(f"heuristic {label}: n={g.n} m={g.m} {r.algorithm} in {wall:.3f} s on "
        f"cuda; {len(calls)} optimize_many calls, "
        f"{sum(len(f) for f, _ in runs)} batched flights, "
        f"{sum(len(s) for _, s in runs)} solo runs and {len(latt)} lattice "
        f"runs, "
        f"{sum(len(c[0]) for c in calls)} subproblems (n "
        f"{min(x.n for c in calls for x in c[0])}-"
        f"{max(x.n for c in calls for x in c[0])}); optimize_many "
        f"{inside:.3f} s, the heuristic's host work {wall - inside:.3f} s; "
        f"stage seconds " + json.dumps({k: round(v, 4) for k, v in
                                        sorted(stages.items())})
        + "; launches " + json.dumps(launches))
    want = sum(bspan_launches(gs, algo) for gs, algo, _, _, _ in calls) + \
        sum(lattice_spans(x.n, shards) for x in latt)
    got = launches.get("bconnectivity_span", 0)
    if got != want:
        raise AssertionError(f"{label}: {got} bconnectivity_span launches for "
                             f"{want} levels and flights")
    want = sum(span_launches(x) for _, solo in runs for x in solo)
    got = launches.get("connectivity_span", 0)
    if got != want:
        raise AssertionError(f"{label}: {got} connectivity_span launches for "
                             f"{want} level spans of solo subproblems")
    validate_plan(r.plan, g)
    canon = cost_plan(r.plan, g).cost
    if r.cost != canon:
        raise AssertionError(f"{label}: cost {r.cost} is not its plan's "
                             f"{canon}")
    return r, calls


def phase_heuristics():
    """The heuristics path on cuda, launch counters read around exactly
    it; the cpu runs of h1, h2 and h5 go on in worker processes meanwhile.
    Returns the launches and each part's (result, sub-solver calls)."""
    parts = heuristic_parts()
    t_start = time.perf_counter()
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=3, mp_context=spawn) as pool:
        futs = {i: pool.submit(heuristic_cpu_run, i)
                for i, p in enumerate(parts) if p[4]}
        out = {}
        ops.reset_launches()
        with ChunkCalls() as chunks:
            for i, (label, mod, g, opts, _) in enumerate(parts):
                out[i] = run_heuristic(label, mod, g, opts)
        heur = dict(ops.LAUNCHES)
        log(f"heuristics path: {time.perf_counter() - t_start:.1f} s on cuda; "
            f"launches " + json.dumps(heur))
        check_path("heuristics", heur, HEUR_PATH, chunks.count, typed=True)
        cpu = {i: f.result() for i, f in futs.items()}
    log(f"heuristics cpu runs: {len(cpu)} parts, done at "
        f"{time.perf_counter() - t_start:.1f} s (3 worker processes)")
    for i, (label, mod, g, _, vs_cpu) in enumerate(parts):
        r, calls = out[i]
        note = []
        if mod == "uniondp" and not g.typed:
            goo_cost = goo.solve(g).cost
            rc = r.info["round_costs"]
            if r.cost > goo_cost * (1 + GOO_EPS):
                raise AssertionError(f"{label}: cost {r.cost} above GOO's "
                                     f"{goo_cost} x (1 + {GOO_EPS})")
            if any(b > a for a, b in zip(rc, rc[1:])):
                raise AssertionError(f"{label}: round costs rise: {rc}")
            note.append(f"{r.cost / goo_cost!r} x GOO, round costs "
                        f"non-increasing {rc}")
        if vs_cpu:
            note.append(hold_against_cpu(label, r, calls, cpu[i]))
        log(f"heuristic {label}: plan valid"
            + (" (conflict rules included)" if g.typed else "")
            + f", cost {r.cost!r} == cost_plan of its plan"
            + "".join(f"; {x}" for x in note))
    return heur, out

# ---------------------------------------------------------------- phase 8 --

SERVICE_PATH = SPAN_FORMS + INNER_FORMS        # flights, solo d1/d3, s4
EVAL_FORMS = ("bccp_eval_decode", "btree_eval_decode",
              "bgeneral_eval_decode") + FUSED_FORMS
S3_DUPS = 16                                   # relabelled duplicates in s3


def relabel(g, seed: int):
    """An isomorphic copy of the inner-join graph ``g`` under a seeded
    vertex permutation, its log2 stats carried bit for bit."""
    perm = np.random.default_rng(seed).permutation(g.n).tolist()
    inv = [0] * g.n
    for old, new in enumerate(perm):
        inv[new] = old
    return JoinGraph.from_log2(
        g.n, [(perm[u], perm[v]) for u, v in g.edges],
        [g.log2_card[inv[v]] for v in range(g.n)], list(g.log2_sel),
        names=[g.names[inv[v]] for v in range(g.n)],
        fans_l2=None if g.fan_l2 is None else list(g.fan_l2))


def same_results(label, got, want) -> None:
    """Raise unless two runs' results are bit for bit equal: cost ``==``,
    plan shape, ``Counters`` and ``algorithm``."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results for {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        ka = (a.cost, plan_shape(a.plan), a.counters.evaluated,
              a.counters.ccp, a.algorithm)
        kb = (b.cost, plan_shape(b.plan), b.counters.evaluated,
              b.counters.ccp, b.algorithm)
        if ka != kb:
            raise AssertionError(f"{label} query {i}: {a.algorithm} {a.cost!r} "
                                 f"{a.counters} vs {b.algorithm} {b.cost!r} "
                                 f"{b.counters}")


def stream_stages(res, rep) -> dict:
    """Stage seconds summed over a stream's flights and solo runs."""
    members = {qi for fl in rep.flights for qi in fl.queries}
    runs = [fl.queries[0] for fl in rep.flights] + [
        qi for qi, r in enumerate(res)
        if qi not in members and not r.algorithm.startswith("cache[")]
    stages = {}
    for qi in runs:
        for k, v in res[qi].timings.items():
            stages[k] = stages.get(k, 0.0) + v
    return {k: round(v, 4) for k, v in sorted(stages.items())}


def run_service(label, graphs, algorithm, pipeline, cache=None):
    """One ``service.optimize_stream`` run on cuda, timed and printed: its
    flights (each ``wall_s`` and ``finalize_s``), latency percentiles,
    stage seconds, telemetry summary and launches.  Without a cache it
    raises unless the flights are ``admit``'s and the filters made one
    launch per level and flight (batched) and per level span (solo).
    Returns (results, report, wall, launches)."""
    before = dict(ops.LAUNCHES)
    (res, rep), wall = timed(lambda: service.optimize_stream(
        graphs, algorithm, cache=cache, pipeline=pipeline))
    launches = {k: v - before[k] for k, v in ops.LAUNCHES.items()
                if v != before[k]}
    mode = "pipelined" if pipeline else "synchronous"
    pct = rep.latency_percentiles()
    log(f"service {label} {mode}: {len(graphs)} queries in {wall:.3f} s on "
        f"cuda; {len(rep.flights)} flights, {rep.solo} solo, "
        f"{rep.cache_hits} cache hits; latency p50 {pct[50]:.4f} s, p95 "
        f"{pct[95]:.4f} s, p99 {pct[99]:.4f} s; stage seconds "
        + json.dumps(stream_stages(res, rep)) + "; launches "
        + json.dumps(launches))
    for fl in rep.flights:
        log(f"service {label} {mode}: flight {fl.space} nmax {fl.nmax} x"
            f"{len(fl.queries)}: wall_s {fl.wall_s:.4f}, finalize_s "
            f"{fl.finalize_s:.4f}")
    if rep.flights:
        log(f"service {label} {mode}: telemetry "
            + json.dumps(rep.telemetry_summary()))
    if cache is None:
        opt = service.StreamOptimizer(algorithm)
        flights_, solo = opt.admit(graphs, list(range(len(graphs))))
        if [(f.nmax, f.space, f.queries) for f in rep.flights] != \
                [(f.nmax, f.space, f.queries) for f in flights_] \
                or rep.solo != len(solo):
            raise AssertionError(f"service {label}: flights and solo queries "
                                 f"are not admit's")
        check_bspan(f"service {label}", graphs, algorithm, before)
        want = sum(span_launches(graphs[qi]) for qi in solo)
        if launches.get("connectivity_span", 0) != want:
            raise AssertionError(f"service {label}: "
                                 f"{launches.get('connectivity_span', 0)} "
                                 f"connectivity_span launches for {want} "
                                 f"level spans")
    return res, rep, wall, launches


def sync_and_pipelined(label, graphs, algorithm, repeats: int):
    """One synchronous and ``repeats`` pipelined runs: each pipelined run
    bit for bit the synchronous one with equal launches, one solo query.
    Returns the synchronous results, the walls and the launches of one
    run."""
    sync, rep, wall, launches = run_service(label, graphs, algorithm, False)
    walls = {"synchronous": wall, "pipelined": []}
    if rep.solo != 1:
        raise AssertionError(f"service {label}: {rep.solo} solo queries")
    for k in range(repeats):
        pipe, _, wall, got = run_service(label, graphs, algorithm, True)
        same_results(f"service {label} pipelined run {k + 1}", pipe, sync)
        if got != launches:
            raise AssertionError(f"service {label}: launches {got} "
                                 f"pipelined vs {launches} synchronous")
        walls["pipelined"].append(wall)
    log(f"service {label}: {repeats} pipelined runs equal the synchronous "
        f"run bit for bit (cost ==, plan shapes, counters, algorithm) with "
        f"equal launches; walls " + json.dumps(walls))
    return sync, walls, launches


def kernel_of(name: str):
    """The ``ops`` kernel a profiler event name belongs to, or None."""
    for k in KERNELS:
        sym = re.escape(SYMBOL.get(k, f"{k}_kernel"))
        if re.search(rf"(^|[^A-Za-z0-9_]){sym}(?![A-Za-z0-9_])", name):
            return k
    return None


def overlap_us(intervals: dict) -> float:
    """Device microseconds during which kernels of two or more streams
    run (``intervals``: stream -> [(start, end)])."""
    marks = []
    for spans in intervals.values():
        cur = None
        for a, b in sorted(spans):                 # this stream's union
            if cur is not None and a <= cur[1]:
                cur[1] = max(cur[1], b)
                continue
            if cur is not None:
                marks += [(cur[0], 1), (cur[1], -1)]
            cur = [a, b]
        if cur is not None:
            marks += [(cur[0], 1), (cur[1], -1)]
    total, depth, last = 0.0, 0, None
    for t, d in sorted(marks):
        if depth >= 2:
            total += t - last
        depth += d
        last = t
    return total


def device_events(prof):
    """(name, stream, start us, end us) of each device event of a finished
    profile, read from the raw Kineto events: building the profiler's
    ``FunctionEvent`` tree over a stream's 10^5-10^6 events takes
    minutes."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    return [(e.name(), e.device_resource_id(), e.start_ns() / 1e3,
             e.end_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def profile_streams(label, fn):
    """Profile the device work of one call of fn; raise unless every
    ``bconnectivity_span`` launch ran on a CUDA stream on which no
    evaluate kernel ran; print the launches by stream and the device time
    in which two streams' work overlaps."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    intervals, by_kernel, kinds = {}, {}, {}
    events = device_events(prof)
    for name, st, a, b in events:
        intervals.setdefault(st, []).append((a, b))
        if name not in kinds:                 # a few distinct names
            kinds[name] = kernel_of(name)
        k = kinds[name]
        if k is not None:
            by_kernel.setdefault(k, {}).setdefault(st, 0)
            by_kernel[k][st] += 1
    filt = set(by_kernel.get("bconnectivity_span", {}))
    ev = {st for k in EVAL_FORMS for st in by_kernel.get(k, {})}
    busy = sum(b - a for spans in intervals.values() for a, b in spans)
    log(f"profile {label}: wall {wall:.3f} s (profiler on, device activity "
        f"only); launches by stream "
        + json.dumps({k: {str(st): n for st, n in v.items()}
                      for k, v in sorted(by_kernel.items())})
        + f"; {len(events)} device events on {len(intervals)} streams, "
        f"busy {busy / 1e6:.4f} s, two streams overlapping "
        f"{overlap_us(intervals) / 1e6:.6f} s; read in "
        f"{time.perf_counter() - t0 - wall:.1f} s")
    if not filt or not ev or filt & ev:
        raise AssertionError(f"profile {label}: bconnectivity_span on streams "
                             f"{sorted(filt)}, evaluate kernels on "
                             f"{sorted(ev)}: the filter did not run on a "
                             f"stream of its own")
    return out


def phase_service(stream_a, res_a, d1_res, heur_out):
    """The service path on cuda, launch counters read around exactly it
    (s1-s4), then a profile of one pipelined s1 run.  Returns the launches
    and, for phase 9, s1's and s2's graphs, synchronous results and
    launches."""
    t_start = time.perf_counter()
    s1 = stream_a + [gen.musicbrainz_query(20, seed=11)]
    s2 = stream_b() + [gen.musicbrainz_query(17, seed=11)]
    dups = [relabel(s1[i], 100 + i) for i in range(0, 2 * S3_DUPS, 2)]
    s3 = s1 + dups
    distinct = len({canonical_signature(g)[0] for g in s3})
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(build.BUILD_DIR / "phase8.plancache")     # gitignored
    ops.reset_launches()
    with ChunkCalls() as chunks:
        sync1, _, launches1 = sync_and_pipelined("s1", s1, "auto", 3)
        same_results("service s1 vs phase 4's stream (a) and phase 5's d1",
                     sync1, list(res_a) + [d1_res])
        sync2, _, launches2 = sync_and_pipelined("s2", s2, "dpsub", 1)

        cache = PlanCache()
        first, rep, _, _ = run_service("s3 first pass", s3, "auto", True,
                                       cache)
        if (cache.stats.inserts, rep.cache_hits) != (distinct, S3_DUPS):
            raise AssertionError(f"service s3: {cache.stats.inserts} plans "
                                 f"computed for {distinct} distinct queries, "
                                 f"{rep.cache_hits} deferred hits for "
                                 f"{S3_DUPS} duplicates")
        same_results("service s3 first pass vs s1", first[:len(s1)], sync1)
        cache.save(path)
        loaded = PlanCache.load(path)
        os.remove(path)
        if loaded.stale_load or len(loaded) != len(cache):
            raise AssertionError(f"service s3: the saved cache loaded "
                                 f"{len(loaded)} of {len(cache)} entries")
        second, rep, wall, launches = run_service("s3 second pass", s3, "auto",
                                                  True, loaded)
        if launches or rep.flights or rep.solo or rep.cache_hits != len(s3):
            raise AssertionError(f"service s3 second pass: {rep.cache_hits} "
                                 f"hits of {len(s3)}, {len(rep.flights)} "
                                 f"flights, launches {launches}")
        for i, (g, a, b) in enumerate(zip(s3, first, second)):
            if plan_shape(a.plan) != plan_shape(b.plan) or \
                    b.cost != cost_plan(b.plan, g).cost:
                raise AssertionError(f"service s3 query {i}: the hit's plan "
                                     f"or cost differs")
        log(f"service s3: {len(s3)} queries, {distinct} computed once and "
            f"{S3_DUPS} deferred hits; saved and loaded {len(loaded)} "
            f"entries; second pass {len(s3)} hits in {wall:.4f} s, no "
            f"flight, no launch, plans == the first pass's, each cost == "
            f"its cost_plan")

        for j, (label, mod, g, opts, _) in enumerate(heuristic_parts()[:2]):
            r, calls = run_heuristic(f"s4 {label} pipelined", mod, g,
                                     dict(opts, pipeline=True))
            r7, calls7 = heur_out[j]
            if [c[2] for c in calls] != [c[2] for c in calls7] or \
                    (plan_shape(r.plan), r.cost) != (plan_shape(r7.plan),
                                                     r7.cost):
                raise AssertionError(f"s4 {label}: the pipelined run differs "
                                     f"from phase 7's")
            log(f"service s4 {label}: pipelined run equals phase 7's "
                f"synchronous run ({len(calls)} calls, equal plan shapes "
                f"call by call, plan, cost {r.cost!r} ==)")
    svc = dict(ops.LAUNCHES)
    log(f"service path: {time.perf_counter() - t_start:.1f} s on cuda; "
        f"launches " + json.dumps(svc))
    check_path("service", svc, SERVICE_PATH, chunks.count)
    log(f"max_memory_allocated (service path): "
        f"{torch.cuda.max_memory_allocated()} bytes")
    res, _ = profile_streams("service s1 pipelined", lambda: service.
                             optimize_stream(s1, "auto", pipeline=True))
    same_results("service s1 profiled run", res, sync1)
    return svc, {"s1": (s1, sync1, launches1), "s2": (s2, sync2, launches2)}


# ---------------------------------------------------------------- phase 9 --

V6_FAULTS = "worker@1:raise;chunk@5:raise"
WAIT_S = 120.0          # bound of each wait on a daemon (connect, reply)


def client_run(label, c, graphs, before, **kw):
    """One optimize request through DaemonClient ``c``: its wall, the
    reply's metadata and the launches made in this process since
    ``before``, printed.  Returns (results, meta, launches)."""
    t0 = time.perf_counter()
    res = c.optimize(graphs, timeout=WAIT_S, **kw)
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in ops.LAUNCHES.items()
                if v != before[k]}
    st = c.stats()
    pct = st["request_wall_s"]
    log(f"daemon {label}: {len(graphs)} queries, request wall {wall:.3f} s "
        f"(reply wall_s {c.last_meta['wall_s']:.3f}); {c.last_meta['flights']} "
        f"flights, {c.last_meta['solo']} solo, {c.last_meta['cache_hits']} "
        f"cache hits, {c.last_meta['degraded']} degraded; STATS latency p50 "
        f"{pct['p50']:.4f} s, p95 {pct['p95']:.4f} s, p99 {pct['p99']:.4f} s; "
        f"launches " + json.dumps(launches) + "; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    return res, dict(c.last_meta, wall=wall), launches


def check_hits(label, graphs, got, want) -> None:
    """Cache hits: the computed run's plan shapes, each cost == its
    ``cost_plan`` on the probing graph."""
    for i, (g, a, b) in enumerate(zip(graphs, got, want)):
        if plan_shape(a.plan) != plan_shape(b.plan) or \
                a.cost != cost_plan(a.plan, g).cost:
            raise AssertionError(f"{label} query {i}: the hit's plan or cost "
                                 f"differs")


def v4_parts():
    """v4's request: 32 queries of 12-16 relations and one of 20 (solo)."""
    return gen.mixed_stream(32, seed=2, sizes=(12, 13, 14, 15, 16)) + \
        [gen.musicbrainz_query(20, seed=13)]


def check_degraded(label, graphs, res, exact, goo_costs, cache) -> int:
    """Every degraded result stops short (``levels_done <
    levels_total``), costs no less than the exact run's (f32 on the card
    against the stitch's host ``cost_plan``: relative 1e-5) and no more
    than GOO's, and is not in the cache; every other result is the exact
    run's, or a hit (two of v4's queries are canonically v3's) within 1e-5
    of it.  Returns the count."""
    n = 0
    for i, (g, r, e, gc) in enumerate(zip(graphs, res, exact, goo_costs)):
        validate_plan(r.plan, g)
        if "degraded" not in r.info:
            hit = r.algorithm.startswith("cache[")
            if (r.cost != e.cost and not hit) or rel(r.cost, e.cost) > 1e-5:
                raise AssertionError(f"{label} query {i}: {r.algorithm} cost "
                                     f"{r.cost!r} vs {e.cost!r}")
            continue
        n += 1
        d = r.info["degraded"]
        if not d["levels_done"] < d["levels_total"]:
            raise AssertionError(f"{label} query {i}: degraded {d}")
        if r.cost < e.cost * (1 - 1e-5) or r.cost > gc:
            raise AssertionError(f"{label} query {i}: degraded cost "
                                 f"{r.cost!r} outside [exact {e.cost!r}, GOO "
                                 f"{gc!r}]")
        if cache.get(g) is not None:
            raise AssertionError(f"{label} query {i}: a degraded plan was "
                                 f"cached")
    return n


def v5_flights():
    """Stream (c)'s flights as ``optimize_many`` forms them under auto:
    (lane space, member graphs)."""
    stream_c = [gen.chain(8, 1), gen.cycle(7, 2), gen.star(6, 3),
                gen.job_like(8, 4)]
    buckets, _ = batch.bucket_pending(stream_c, list(range(4)), "auto")
    return [(space, [stream_c[q] for q in idxs])
            for (_b, space, _t), idxs in sorted(buckets.items())]


def summary(r):
    return (r.info.get("degraded"), r.levels, r.algorithm,
            r.counters.evaluated, r.counters.ccp, r.cost, plan_shape(r.plan))


def v5_runs(device: str, part) -> list:
    """v5's runs under the fake clock of ``tests/test_faults.py`` on
    ``device`` (on cpu in a worker process): ``faults.now`` returns its
    call count, so ``deadline_s = k - 1.5`` expires at level k.  ``part``
    "flights": stream (c)'s flights synchronous and pipelined at every k;
    an int k: d1 solo under ``mpdp``.  Returns [(label, graphs,
    [summary])]."""
    if device == "cpu":
        torch.set_num_threads(1)
    real, clock = faults.now, itertools.count()
    faults.now = lambda: next(clock)
    out = []
    try:
        if part == "flights":
            for space, members in v5_flights():
                for pipeline in (False, True):
                    for k in range(2, max(g.n for g in members) + 1):
                        rs = batch.BatchEngine(
                            members, algorithm=space, pipeline=pipeline,
                            deadline_s=k - 1.5, device=device).run()
                        mode = "pipelined" if pipeline else "synchronous"
                        out.append((f"{space} {mode} k={k}", members,
                                    [summary(r) for r in rs]))
        else:
            g = gen.musicbrainz_query(20, seed=11)
            r = engine.optimize(g, config=OptimizerConfig(
                algorithm="mpdp", deadline_s=part - 1.5), device=device)
            out.append((f"d1 k={part}", [g], [summary(r)]))
    finally:
        faults.now = real
    return out


def hold_v5(card, cpu) -> tuple:
    """The card's fake-clock runs against the cpu's: degraded dicts,
    levels, algorithm and Counters equal, costs within 1e-5, plans equal or
    a shown tie.  Returns (runs, degraded results, ties, largest ulps)."""
    runs = degraded = ties = worst = 0
    for (label, graphs, a), (label2, _, b) in zip(card, cpu):
        if label != label2 or len(a) != len(b):
            raise AssertionError(f"v5: {label} vs {label2}")
        runs += 1
        for q, (g, x, y) in enumerate(zip(graphs, a, b)):
            if x[:5] != y[:5] or rel(x[5], y[5]) > 1e-5:
                raise AssertionError(f"v5 {label} query {q}: {x[:6]} on cuda "
                                     f"vs {y[:6]} on cpu")
            worst = max(worst, ulps(x[5], y[5]))
            degraded += x[0] is not None
            if x[6] != y[6]:
                ca = cost_plan(plan_of(x[6]), g).cost
                cb = cost_plan(plan_of(y[6]), g).cost
                if rel(ca, cb) > 1e-5:
                    raise AssertionError(f"v5 {label} query {q}: plans "
                                         f"differ ({ca!r} vs {cb!r})")
                ties += 1
                log(f"daemon v5 {label} query {q}: rounding tie, plans cost "
                    f"{ca!r} (cuda) and {cb!r} (cpu)")
    return runs, degraded, ties, worst


def run_daemon_process(tmp, s1, sync1) -> None:
    """v6: ``python -m repro_torch.daemon`` as its own process on the card
    with ``REPRO_FAULTS`` (a worker crash on the first job, a chunk fault
    at the fifth device dispatch), a cache file and a policy file.  The
    first s1 request gets a retryable error; s1 resent pipelined meets the
    chunk fault mid-flight and gets a structured error; s1 resent once
    more (``retries=2``) is bit for bit phase 8's synchronous s1, with the
    policy on; SIGTERM drains the daemon (exit 0) to a cache file that
    serves all of s1 as hits and a policy file that loads."""
    sock = os.path.join(tmp, "v6.sock")
    cache_file = os.path.join(tmp, "v6.plancache")
    policy_file = os.path.join(tmp, "v6.policy")
    env = dict(os.environ, REPRO_FAULTS=V6_FAULTS,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "v6.log"), "w+") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.daemon", "--socket", sock,
             "--cache-file", cache_file, "--policy-file", policy_file],
            env=env, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        try:
            with DaemonClient(socket_path=sock, connect_timeout=WAIT_S,
                              tenant="v6") as c:
                log(f"daemon v6: process up in {time.perf_counter() - t0:.1f}"
                    f" s (REPRO_FAULTS={V6_FAULTS})")
                try:
                    c.optimize(s1, timeout=WAIT_S)
                except DaemonError as e:
                    if not getattr(e, "retryable", False):
                        raise
                    log(f"daemon v6: first request: retryable error: {e}")
                else:
                    raise AssertionError("v6: the worker fault did not fire")
                cfg = OptimizerConfig(pipeline=True)
                try:
                    c.optimize(s1, config=cfg, timeout=WAIT_S)
                except DaemonError as e:
                    if getattr(e, "retryable", False) or \
                            "InjectedFault" not in str(e):
                        raise
                    log(f"daemon v6: pipelined request: structured error: {e}")
                else:
                    raise AssertionError("v6: the chunk fault did not fire")
                res, meta, _ = client_run("v6 resent, pipelined, policy on", c,
                                          s1, dict(ops.LAUNCHES), config=cfg,
                                          retries=2)
                same_results("daemon v6 vs phase 8's synchronous s1", res,
                             sync1)
                st = c.stats()
                if (st["worker_restarts"], st["errors"]) != (1, 1) or \
                        st["exec"]["compiles"] != 0:
                    raise AssertionError(f"v6: STATS {st}")
                log(f"daemon v6: results == phase 8's synchronous s1 (cost "
                    f"==, plan shapes, counters, algorithm); launches in the "
                    f"daemon's own process, not counted here; STATS "
                    f"worker_restarts 1, errors 1, exec " + json.dumps(
                        st["exec"]) + ", policy " + json.dumps(st["policy"]))
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=WAIT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=WAIT_S)
            out.seek(0)
            tail = out.read()[-2000:]
        if rc != 0:
            raise AssertionError(f"v6: the daemon exited {rc}:\n{tail}")
    loaded = PlanCache.load(cache_file)
    table = PolicyTable.load(policy_file)
    if loaded.stale_load or table.stale_load or len(table) == 0:
        raise AssertionError(f"v6: cache file stale {loaded.stale_load}, "
                             f"policy file stale {table.stale_load}")
    before = dict(ops.LAUNCHES)
    hits, rep = service.optimize_stream(s1, "auto", cache=loaded)
    if rep.cache_hits != len(s1) or rep.flights or ops.LAUNCHES != before:
        raise AssertionError(f"v6: the drained cache served {rep.cache_hits} "
                             f"of {len(s1)} as hits")
    check_hits("daemon v6 drained cache", s1, hits, sync1)
    log(f"daemon v6: SIGTERM drained it (exit 0) in {meta['wall']:.3f} s of "
        f"request wall; its cache file serves all {len(s1)} s1 queries as "
        f"hits (no flight, no launch); its policy file loads "
        f"({len(table)} entries); {time.perf_counter() - t0:.1f} s in all")


def phase_daemon(svc_out):
    """The daemon path on cuda: v1-v4 through an ``OptimizerDaemon`` in
    this process (launch counters read around exactly them), v5 the fake
    clock on the card against the cpu (worker processes meanwhile), v6 the
    daemon as its own process.  Returns v1-v4's launches."""
    t_start = time.perf_counter()
    v4 = v4_parts()
    (exact4, _), wall4 = timed(lambda: service.optimize_stream(v4, "auto"))
    goo4 = [goo.solve(g).cost for g in v4]
    log(f"daemon v4: exact run without a deadline in {wall4:.3f} s (in "
        f"process, not counted)")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="d", dir=build.BUILD_DIR)   # gitignored
    try:
        dmn = daemon_parts(tmp, svc_out, (v4, exact4, goo4))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"daemon path (phase 9): {time.perf_counter() - t_start:.1f} s")
    return dmn


def daemon_parts(tmp, svc_out, v4_ref):
    """Phase 9's parts v1-v6 in the directory ``tmp``, against phase 8's
    s1 and s2 (``svc_out``) and v4's exact and GOO costs (``v4_ref``);
    returns v1-v4's launches."""
    t_start = time.perf_counter()
    s1, sync1, launches1 = svc_out["s1"]
    s2, sync2, launches2 = svc_out["s2"]
    v4, exact4, goo4 = v4_ref
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=4, mp_context=spawn) as pool:
        futs = [pool.submit(v5_runs, "cpu", part)
                for part in ("flights", 4, 8, 12)]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        d = OptimizerDaemon(socket_path=os.path.join(tmp, "v.sock"),
                            device="cuda")
        d.start()
        try:
            with ChunkCalls() as chunks, \
                    DaemonClient(socket_path=d.address,
                                 connect_timeout=WAIT_S, tenant="smoke") as c:
                exec0 = c.stats()["exec"]
                res, meta, got = client_run("v1 s1 auto synchronous", c, s1,
                                            dict(ops.LAUNCHES))
                same_results("daemon v1 vs phase 8's synchronous s1", res,
                             sync1)
                if got != launches1 or meta["cache_hits"]:
                    raise AssertionError(f"v1: launches {got} vs phase 8's "
                                         f"{launches1}")
                log(f"daemon v1: == phase 8's synchronous s1 (cost ==, plan "
                    f"shapes, counters, algorithm) with equal launches")
                wall1 = meta["wall"]

                res2, meta, got = client_run(
                    "v2 s1 pipelined", c, s1, dict(ops.LAUNCHES),
                    config=OptimizerConfig(pipeline=True))
                exec2 = c.stats()["exec"]
                if meta["cache_hits"] != len(s1) or meta["flights"] or got \
                        or exec2["compiles"] != exec0["compiles"]:
                    raise AssertionError(f"v2: {meta}, launches {got}, exec "
                                         f"{exec0} -> {exec2}")
                check_hits("daemon v2", s1, res2, sync1)
                log(f"daemon v2: {len(s1)} cache hits, no flight, no launch, "
                    f"exec " + json.dumps(exec2) + " (compiles unchanged "
                    "since serving started)")

                res, meta, got = client_run(
                    "v3 s2 dpsub", c, s2, dict(ops.LAUNCHES),
                    config=OptimizerConfig(algorithm="dpsub"))
                same_results("daemon v3 vs phase 8's synchronous s2", res,
                             sync2)
                if got != launches2 or meta["cache_hits"]:
                    raise AssertionError(f"v3: launches {got} vs phase 8's "
                                         f"{launches2}")
                log("daemon v3: == phase 8's synchronous s2 with equal "
                    "launches")

                dl = wall1 / 4
                res, meta, got = client_run(
                    f"v4 deadline_s {dl:.3f}", c, v4, dict(ops.LAUNCHES),
                    config=OptimizerConfig(deadline_s=dl))
                n = check_degraded("daemon v4", v4, res, exact4, goo4,
                                   d.cache)
                if n == 0 or n != meta["degraded"]:
                    raise AssertionError(f"v4: {n} degraded results, reply "
                                         f"says {meta['degraded']}")
                log(f"daemon v4: {n} of {len(v4)} results degraded (each "
                    f"levels_done < levels_total, cost in [exact, GOO], not "
                    f"cached); reply overrun past deadline_s "
                    f"{meta['wall_s'] - dl:.3f} s (reply wall_s "
                    f"{meta['wall_s']:.3f} s), client wall {meta['wall']:.3f}"
                    f" s")
            dmn = dict(ops.LAUNCHES)
        finally:
            d.drain()
        if not d._stopped.wait(WAIT_S):
            raise AssertionError("the in-process daemon did not drain")
        log("daemon path: launches " + json.dumps(dmn))
        check_path("daemon", dmn, SERVICE_PATH, chunks.count)
        log(f"max_memory_allocated (daemon v1-v4): "
            f"{torch.cuda.max_memory_allocated()} bytes; v1-v4 in "
            f"{time.perf_counter() - t_start:.1f} s")

        card = [run for part in ("flights", 4, 8, 12)
                for run in v5_runs("cuda", part)]
        cpu = [run for f in futs for run in f.result()]
    runs, degraded, ties, worst = hold_v5(card, cpu)
    log(f"daemon v5: fake clock on the card: {runs} runs (stream (c)'s "
        f"flights synchronous and pipelined at every k, d1 at k 4, 8, 12), "
        f"{degraded} degraded results; levels_done, Counters and degraded "
        f"dicts == the cpu run's, costs within 1e-5 (max {worst} ulp), "
        f"{ties} rounding ties")

    run_daemon_process(tmp, s1, sync1)
    return dmn


# --------------------------------------------------------------- phase 10 --

SHARDS = 4                      # logical shards of the one card
SHARDED_PATH = INNER_FORMS      # sharded flights and the lattice
EVAL_OF = {"dpsub": "bccp_eval_decode", "mpdp_tree": "btree_eval_prune",
           "mpdp_general": "bgeneral_eval_prune"}
TYPED_EVAL_OF = {"dpsub": "bccp_eval_decode", "mpdp_tree": "btree_eval_decode",
                 "mpdp_general": "bgeneral_eval_decode"}


def eval_form(space: str, typed: bool) -> str:
    """The kernel a chunk of ``space`` launches: typed flights keep the
    decode forms."""
    return (TYPED_EVAL_OF if typed else EVAL_OF)[space]


def card_mesh(n: int):
    """A mesh of ``n`` logical shards of the one card."""
    return shard.batch_mesh([DEV] * n)


class LaneSpy:
    """Records, while it is entered, each (query, level)'s evaluate lanes
    as the batched engine builds them: from the offsets of
    ``_eval_begin`` (DPSUB, tree) and the pair tables of
    ``_eval_general_begin`` (general)."""

    def __init__(self):
        self.lanes = {}                 # (id(graph), level) -> lanes

    def __enter__(self):
        E = batch.BatchEngine
        self.real = (E._eval_begin, E._eval_general_begin)
        seg, gen_ = self.real

        def begin(eng, i, sets_by_q):
            ctx = seg(eng, i, sets_by_q)
            if ctx is not None:
                for q, g in enumerate(eng.graphs):
                    self.lanes[id(g), i] = int(ctx["eoff"][q + 1]
                                               - ctx["eoff"][q])
            return ctx

        def gbegin(eng, sets_by_q, pairs):
            ctx = gen_(eng, sets_by_q, pairs)
            if ctx is not None:
                ps, pb, pq, _ = pairs
                i = int(bs.np_popcount(ps[:1])[0])
                sz = (np.int64(1) << bs.np_popcount(pb).astype(np.int64))
                per = np.zeros(eng.B, np.int64)
                np.add.at(per, pq, sz)
                for q, g in enumerate(eng.graphs):
                    self.lanes[id(g), i] = int(per[q])
            return ctx

        E._eval_begin, E._eval_general_begin = begin, gbegin
        return self

    def __exit__(self, *exc):
        batch.BatchEngine._eval_begin, batch.BatchEngine._eval_general_begin \
            = self.real


def pad_lanes() -> dict:
    """Level-2 lanes of the 2-relation pad query in each lane space (a
    cpu run)."""
    out = {}
    for space in EVAL_OF:
        pad = shard._pad_graph()
        with LaneSpy() as spy:
            batch.BatchEngine([pad], algorithm=space, device="cpu").run()
        out[space] = spy.lanes[id(pad), 2]
    return out


def sharded_prediction(graphs, algorithm, D, lanes, pads) -> dict:
    """Launches ``optimize_many(devices=D)`` makes on ``graphs``: per
    flight (up to MAX_FLIGHT x D queries of a bucket, dealt round-robin
    and padded with 2-relation queries), level and shard, one
    ``bconnectivity_span`` launch per ``SPAN`` ranks and one evaluate
    launch per ``CHUNK`` lanes; ``lanes`` are the single-shard run's lanes
    per (query, level), ``pads`` the pad's level-2 lanes.  A shard's tree
    and general chunks launch the decode forms where it holds a typed
    query, the fused forms where not (a shard of pads alone too)."""
    pending = batch.probe_stream(graphs, [None] * len(graphs), None,
                                 algorithm)
    buckets, solo = batch.bucket_pending(graphs, pending, algorithm)
    want = {k: 0 for k in BATCHED_FORMS + FUSED_FORMS}
    for (_, space, _), idxs in sorted(buckets.items()):
        step = MAX_FLIGHT * D
        for s0 in range(0, len(idxs), step):
            group = [graphs[q] for q in idxs[s0: s0 + step]]
            padded = group + [None] * ((-len(group)) % D)     # None: a pad
            for d in range(D):
                members = padded[d::D]
                typed = any(g is not None and g.typed for g in members)
                for i in range(2, max(g.n for g in group) + 1):
                    ranks = sum(comb(2 if g is None else g.n, i)
                                for g in members)
                    want["bconnectivity_span"] += -(-ranks // engine.SPAN)
                    lanes_d = sum((pads[space] if i == 2 else 0) if g is None
                                  else lanes.get((id(g), i), 0)
                                  for g in members)
                    want[eval_form(space, typed)] += -(-lanes_d // L_MAIN)
    return want


def check_launches(label, got: dict, want: dict) -> None:
    diff = {k: (got.get(k, 0), n) for k, n in want.items()
            if got.get(k, 0) != n}
    if diff:
        raise AssertionError(f"{label}: launches (got, predicted) {diff}")


class ShardFailures:
    """Records, while it is entered, every exception a sharded flight's
    level loop raises: ``optimize_many`` and the service would run such a
    flight again on one device and mark it ``redispatched``, which the
    heuristics' sub-solver calls do not return."""

    def __init__(self):
        self.errors = []

    def __enter__(self):
        real = self.real = shard.ShardedBatchEngine.run_levels
        errors = self.errors

        def run_levels(eng):
            try:
                return real(eng)
            except Exception as e:
                errors.append(repr(e))
                raise
        shard.ShardedBatchEngine.run_levels = run_levels
        return self

    def __exit__(self, *exc):
        shard.ShardedBatchEngine.run_levels = self.real


def no_redispatch(label, results) -> None:
    bad = [i for i, r in enumerate(results) if r.info.get("redispatched")]
    if bad:
        raise AssertionError(f"{label}: results {bad} were redispatched")


def same_modulo_lattice(label, got, want) -> None:
    """``same_results``, but a query that ran on the lattice here and solo
    there keeps its algorithm apart from the ``lattice_`` prefix."""
    fixed = []
    for a, b in zip(got, want):
        if a.algorithm == f"lattice_{b.algorithm}":
            a = dataclasses.replace(a, algorithm=b.algorithm)
        fixed.append(a)
    same_results(label, fixed, want)


def run_sharded(label, graphs, algorithm, mesh_kw, want_res, lanes, pads):
    """One stream through ``optimize_many`` on a mesh: bit for bit
    ``want_res`` (phase 4's run), launches as predicted.  Returns the
    launches."""
    D = shard.mesh_size(mesh_kw["mesh"])
    before = dict(ops.LAUNCHES)
    res, wall = timed(lambda: batch.optimize_many(graphs, algorithm,
                                                  **mesh_kw))
    got = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    no_redispatch(label, res)
    same_results(f"sharded {label} vs phase 4", res, want_res)
    check_launches(f"sharded {label}", got,
                   sharded_prediction(graphs, algorithm, D, lanes, pads))
    stages = {}
    for st in {tuple(sorted(r.timings.items())) for r in res}:
        for k, v in st:
            stages[k] = round(stages.get(k, 0.0) + v, 4)
    log(f"sharded {label}: {len(graphs)} queries ({algorithm}) on {D} "
        f"shard(s) of the card in {wall:.3f} s; == phase 4's run (cost ==, "
        f"plan shapes, counters, algorithm); launches as predicted "
        + json.dumps(got) + "; stage seconds " + json.dumps(stages))
    return got


class LatticeSpy:
    """Records, while it is entered, the lattice engines built (through
    ``lattice.LatticeShardedEngine``) and the lane totals they partition,
    in call order (per level: the filter's ranks, then the evaluate's
    lanes)."""

    def __init__(self):
        self.engines, self.totals = [], []

    def __enter__(self):
        real_cls, real_part = lattice.LatticeShardedEngine, lattice.partition_lanes
        self.real = (real_cls, real_part)
        spy = self

        class Spied(real_cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                spy.engines.append(self)

        def part(total, parts):
            spy.totals.append(int(total))
            return real_part(total, parts)

        lattice.LatticeShardedEngine, lattice.partition_lanes = Spied, part
        return self

    def __exit__(self, *exc):
        lattice.LatticeShardedEngine, lattice.partition_lanes = self.real


def lattice_prediction(n: int, totals, D: int) -> dict:
    """Launches of one synchronous lattice run of an n-relation query on D
    shards: per level one ``bconnectivity_span`` launch per shard with
    ranks (C(n, i) split by ``partition_lanes``, ``SPAN`` ranks a launch)
    and one evaluate launch per shard and ``CHUNK`` of its lanes (the
    level's lane total, ``totals[2k + 1]``, split the same way)."""
    if len(totals) != 2 * (n - 1) or any(
            totals[2 * k] != comb(n, k + 2) for k in range(n - 1)):
        raise AssertionError(f"lattice totals {totals} are not (ranks, lanes)"
                             f" per level of n = {n}")
    spans = evals = 0
    for k in range(n - 1):
        spans += sum(-(-int(x) // engine.SPAN)
                     for x in np.diff(partition_lanes(totals[2 * k], D)))
        evals += sum(-(-int(x) // L_MAIN)
                     for x in np.diff(partition_lanes(totals[2 * k + 1], D)))
    return {"bconnectivity_span": spans, "evals": evals}


def lattice_cpu_run(n_shards: int):
    """d1 on the port's cpu lattice over ``n_shards`` logical cpu shards
    (in a worker process): cost, plan shape, counters."""
    torch.set_num_threads(4)
    g = solo_parts()[0][1]
    r = lattice.optimize_lattice(g, "mpdp", mesh=["cpu"] * n_shards,
                                 device="cpu")
    return r.cost, plan_shape(r.plan), (r.counters.evaluated, r.counters.ccp)


def run_lattice(label, g, algorithm, D, want, launches=None):
    """One query through ``engine.optimize`` with the lattice on D logical
    shards: cost ``==`` and plan shape of ``want`` (its solo run), or a
    shown tie; ``Counters`` exact; one collective a level; memo replicas
    equal; launches as predicted, or with ``launches`` (a synchronous
    run's) the pipelined loop and those launches.  Returns (result,
    launches, engine)."""
    if launches is not None:
        kw = {"config": OptimizerConfig(algorithm=algorithm, lattice=True,
                                        mesh=card_mesh(D), pipeline=True)}
    elif D == 1:
        kw = {"algorithm": algorithm, "lattice_devices": 1}
    else:
        kw = {"algorithm": algorithm, "lattice_mesh": card_mesh(D)}
    before = dict(ops.LAUNCHES)
    c0 = collectives.STATS.snapshot()
    with warnings.catch_warnings(), LatticeSpy() as spy:
        warnings.simplefilter("ignore", DeprecationWarning)
        r, wall = timed(lambda: engine.optimize(g, **kw))
    got = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    [eng] = spy.engines
    if r.algorithm != f"lattice_{eng.algorithm}" or eng.D != D:
        raise AssertionError(f"lattice {label}: {r.algorithm} on {eng.D}")
    ncoll = collectives.STATS.snapshot() - c0
    if eng.collectives != g.n - 1 or ncoll != g.n - 1:
        raise AssertionError(f"lattice {label}: {eng.collectives} "
                             f"collectives ({ncoll} counted) for {g.n - 1} "
                             f"levels")
    mc, ml = eng.memo_replicas()
    if not all((mc[d] == mc[0]).all() and (ml[d] == ml[0]).all()
               for d in range(D)):
        raise AssertionError(f"lattice {label}: memo replicas differ")
    if launches is None:
        pred = lattice_prediction(g.n, spy.totals, D)
        launches = {"bconnectivity_span": pred["bconnectivity_span"],
                    eval_form(eng.algorithm, eng.typed): pred["evals"]}
    elif not eng.pipeline:
        raise AssertionError(f"lattice {label}: not pipelined")
    check_launches(f"lattice {label}", got, launches)
    note = "plan shape =="
    if plan_shape(r.plan) != plan_shape(want.plan):
        ca = cost_plan(r.plan, g).cost
        cb = cost_plan(plan_of(plan_shape(want.plan)), g).cost
        if abs(ca - cb) > 1e-5 * abs(cb):
            raise AssertionError(f"lattice {label}: plan cost {ca} vs {cb}")
        note = f"a tie broken by rounding ({ca!r} vs {cb!r})"
    if r.cost != want.cost or (r.counters.evaluated, r.counters.ccp) != \
            (want.counters.evaluated, want.counters.ccp):
        raise AssertionError(f"lattice {label}: {r.cost!r} {r.counters} vs "
                             f"{want.cost!r} {want.counters}")
    log(f"lattice {label}: n={g.n} {r.algorithm} on {D} shard(s) of the card "
        f"in {wall:.3f} s; cost == the solo run's, {note}, counters "
        f"{r.counters} ==; {eng.collectives} collectives (one a level), "
        f"memo replicas equal; launches as "
        f"{'the synchronous run' if eng.pipeline else 'predicted'} "
        + json.dumps(got)
        + "; stage seconds " + json.dumps({k: round(v, 4) for k, v in
                                           r.timings.items()}))
    return r, got, eng


def x6_daemon(s1, sync1) -> None:
    """x6: an ``OptimizerDaemon(devices=1)`` on the card serving s1 (d1 on
    the lattice), equal to phase 8's; a request pinning ``devices=2`` is
    answered with the mesh's structured error."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="x", dir=build.BUILD_DIR)   # gitignored
    try:
        d = OptimizerDaemon(socket_path=os.path.join(tmp, "x.sock"),
                            devices=1, device="cuda")
        d.start()
        try:
            with DaemonClient(socket_path=d.address, connect_timeout=WAIT_S,
                              tenant="x6") as c:
                res, meta, _ = client_run("x6 s1 devices=1", c, s1,
                                          dict(ops.LAUNCHES))
                no_redispatch("x6", res)
                if meta["lattice"] != 1 or meta["solo"]:
                    raise AssertionError(f"x6: {meta}")
                same_modulo_lattice("daemon x6 vs phase 8's s1", res, sync1)
                try:
                    c.optimize(s1[:1], timeout=WAIT_S,
                               config=OptimizerConfig(devices=2))
                except DaemonError as e:
                    if "only 1 cuda device" not in str(e):
                        raise
                    log(f"daemon x6: a request pinning devices=2 answered "
                        f"with the structured error: {e}")
                else:
                    raise AssertionError("x6: devices=2 served on one card")
                if not c.ping():
                    raise AssertionError("x6: the daemon stopped answering")
            log("daemon x6: s1 with devices=1 == phase 8's synchronous s1 "
                "(d1 on the lattice)")
        finally:
            d.drain()
        if not d._stopped.wait(WAIT_S):
            raise AssertionError("the x6 daemon did not drain")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_sharded(res4, solo_res, t20, heur_out, svc_out):
    """Batch sharding and the lattice on the card (x1-x6, l1-l4), launch
    counters read around exactly them; d1 on the cpu lattice runs in a
    worker process meanwhile.  Logical shards of one card run one after
    another.  Returns the launches."""
    t_start = time.perf_counter()
    streams = {"a": (gen.mixed_stream(32, seed=0, sizes=(12, 13, 14, 15, 16)),
                     "auto"),
               "b": (stream_b(), "dpsub"),
               "c": ([gen.chain(8, 1), gen.cycle(7, 2), gen.star(6, 3),
                      gen.job_like(8, 4)], "auto")}
    pads = pad_lanes()
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=spawn) as pool:
        cpu_fut = pool.submit(lattice_cpu_run, 2)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with ChunkCalls() as chunks, ShardFailures() as failures:
            # x1: one shard, bit for bit phase 4 with its launches
            walls = {}
            with LaneSpy() as spy:
                for label, (graphs, algorithm) in streams.items():
                    before = dict(ops.LAUNCHES)
                    res, walls[label] = timed(lambda: batch.optimize_many(
                        graphs, algorithm, devices=1))
                    got = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
                    no_redispatch(f"x1 {label}", res)
                    same_results(f"sharded x1 stream ({label}) vs phase 4",
                                 res, res4[label])
                    if got != STREAM_LAUNCHES[label]:
                        raise AssertionError(f"x1 ({label}): launches {got} "
                                             f"vs phase 4's")
            log(f"sharded x1: streams (a), (b), (c) with devices=1 == phase "
                f"4's runs (cost ==, plan shapes, counters, algorithm) with "
                f"equal launches per kernel; walls (s) " + json.dumps(
                    {k: round(v, 3) for k, v in walls.items()}))
            # x2, x3: four and three logical shards
            run_sharded("x2 stream (a)", *streams["a"],
                        {"mesh": card_mesh(SHARDS)}, res4["a"], spy.lanes,
                        pads)
            run_sharded("x2 stream (b)", *streams["b"],
                        {"mesh": card_mesh(SHARDS)}, res4["b"], spy.lanes,
                        pads)
            run_sharded("x3 stream (c)", *streams["c"],
                        {"mesh": card_mesh(3)}, res4["c"], spy.lanes, pads)
            for label in ("b", "c"):      # the pipelined loop, a stream pair
                run_sharded(f"x2 stream ({label}) pipelined", *streams[label],
                            {"mesh": card_mesh(SHARDS), "pipeline": True},
                            res4[label], spy.lanes, pads)

            # l1-l4: the lattice
            d1g, d2g, d3g = (p[1] for p in solo_parts()[:3])
            r1, _, _ = run_lattice("l1 d1 x1", d1g, "mpdp", 1, solo_res["d1"])
            r4, got4, _ = run_lattice(f"l1 d1 x{SHARDS}", d1g, "mpdp",
                                      SHARDS, solo_res["d1"])
            run_lattice(f"l1 d1 x{SHARDS} pipelined", d1g, "mpdp", SHARDS,
                        solo_res["d1"], launches=got4)
            if (r1.counters.evaluated, r1.counters.ccp) != \
                    (r4.counters.evaluated, r4.counters.ccp):
                raise AssertionError("l1: counters differ between 1 and 4 "
                                     "shards")
            run_lattice(f"l2 d2 x{SHARDS}", d2g, "mpdp_tree", SHARDS,
                        solo_res["d2"])
            run_lattice(f"l3 d3 x{SHARDS}", d3g, "dpsub", SHARDS,
                        solo_res["d3"])
            t20g = typed_parts()[1][0][1]
            run_lattice(f"l4 t20 x{SHARDS}", t20g, "mpdp", SHARDS, t20)

            # x4: s1 through the service on four logical shards
            s1, sync1, _ = svc_out["s1"]
            before = dict(ops.LAUNCHES)
            (res, rep), wall = timed(lambda: service.optimize_stream(
                s1, "auto", mesh=card_mesh(SHARDS)))
            latt = [f for f in rep.flights if f.lattice]
            if rep.lattice != 1 or len(latt) != 1 or \
                    latt[0].queries != [len(s1) - 1] or rep.solo:
                raise AssertionError(f"x4: lattice flights {rep.lattice}, "
                                     f"solo {rep.solo}")
            no_redispatch("x4", res)
            same_modulo_lattice("sharded x4 vs phase 8's s1", res, sync1)
            log(f"sharded x4: s1 through the service on {SHARDS} shards in "
                f"{wall:.3f} s; {len(rep.flights)} flights (d1 a lattice "
                f"flight at nmax {latt[0].nmax}), no solo; == phase 8's "
                f"synchronous s1 (d1 as lattice_{sync1[-1].algorithm}); "
                f"launches " + json.dumps(
                    {k: v - before[k] for k, v in ops.LAUNCHES.items()
                     if v != before[k]}))

            # x5: h4 with devices=1: its 17-20-relation subproblems on the
            # lattice, round by round phase 7's
            label, mod, g, opts, _ = heuristic_parts()[4]
            r7, calls7 = heur_out[4]
            with LatticeSpy() as lspy:
                r, calls = run_heuristic(f"x5 {label} devices=1", mod, g,
                                         dict(opts, devices=1), shards=1)
            big = sorted(e.g.n for e in lspy.engines)
            if not big or min(big) <= batch.NMAX_BATCH:
                raise AssertionError(f"x5: lattice subproblems {big}")
            ref7 = ([([graph_to_wire(x) for x in gs], shapes)
                     for gs, _, shapes, _, _ in calls7], plan_shape(r7.plan),
                    r7.cost, (r7.counters.evaluated, r7.counters.ccp))
            log(f"sharded x5: {len(big)} subproblems (n {big[0]}-{big[-1]}) "
                f"on the lattice; " + hold_against_cpu(f"x5 {label}", r,
                                                       calls, ref7)
                .replace("the cpu run", "phase 7's run"))

            # x6: a daemon with devices=1 on the card serving s1
            x6_daemon(s1, sync1)
        shd = dict(ops.LAUNCHES)
        if failures.errors:
            raise AssertionError(f"sharded flights failed and were "
                                 f"redispatched: {failures.errors}")
        check_path("sharded", shd, SHARDED_PATH, chunks.count, typed=True)
        solo_made = {k: shd[k] for k in SPAN_FORMS if shd[k]}
        if solo_made:
            raise AssertionError(f"solo launches on the sharded path: "
                                 f"{solo_made}")
        log(f"sharded path: launches " + json.dumps(shd) + "; no solo launch, "
            f"no sharded flight failed (none redispatched); "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")

        # l1 against the port's cpu lattice on 2 logical shards
        cost, shape_, counters = cpu_fut.result()
        if counters != (r4.counters.evaluated, r4.counters.ccp) or \
                rel(r4.cost, cost) > 1e-5:
            raise AssertionError(f"l1: cuda {r4.cost} {r4.counters} vs cpu "
                                 f"{cost} {counters}")
        note = "plan shape =="
        if shape_ != plan_shape(r4.plan):
            ca = cost_plan(r4.plan, d1g).cost
            cb = cost_plan(plan_of(shape_), d1g).cost
            if abs(ca - cb) > 1e-5 * abs(cb):
                raise AssertionError(f"l1: plan cost {ca} on cuda vs {cb} on "
                                     f"cpu")
            note = (f"plan shapes differ: a tie broken by rounding (cost_plan "
                    f"{ca!r} on cuda, {cb!r} on cpu)")
        log(f"lattice l1 vs the cpu lattice on 2 shards: counters exact, "
            f"cost within 1e-5 ({ulps(r4.cost, cost)} ulp), {note}")

    log(f"sharded path (phase 10): {time.perf_counter() - t_start:.1f} s; "
        f"logical shards of one card run one after another")
    return shd


# --------------------------------------------------------------- phase 11 --

# the execute path's optimizers: solo mpdp and dpsub (e1, e2, e3's n = 20)
# and the batched flights of optimize_many, IDP2 and UnionDP (no DPSUB one)
EXEC_PATH = SPAN_FORMS + ("bconnectivity_span",) + FUSED_FORMS
FIG10 = (8, 10, 12)           # musicbrainz_query(n, seed=n): the reference's
FIG10_ROWS = 3000             # Fig. 10 setting (benchmarks/paper_figs.py)
E2_ROWS = 30000
HYPER = [(n, s) for n in (12, 14, 16) for s in range(4)]
EXAMPLE_TIMEOUT_S = 300
QUERY_LINE = re.compile(r"^Q(\d+): n=\s*(\d+) algo=(\S+)\s+cost=\s*(\S+) "
                        r"exec=\s*\S+ms rows=(\d+) cost_exact=(\S+)$")


class Intermediates:
    """The largest join result (rows, columns) that ``executor._join``
    returns while it is entered."""

    def __init__(self):
        self.largest = (0, 0)
        self.real = ex._join

    def __enter__(self):
        def spy(*args):
            out = self.real(*args)
            if out.count * len(out.rels) > self.largest[0] * self.largest[1]:
                self.largest = (out.count, len(out.rels))
            return out
        ex._join = spy
        return self

    def __exit__(self, *exc):
        ex._join = self.real


def fig10_plans(g):
    """(label, result, optimize seconds) of the six optimizers on the card
    (DPccp and GOO run on its host)."""
    runs = [("mpdp", lambda: engine.optimize(g, "mpdp")),
            ("dpccp", lambda: engine.optimize(g, "dpccp")),
            ("dpsub", lambda: engine.optimize(g, "dpsub")),
            ("goo", lambda: goo.solve(g)),
            ("idp2", lambda: idp.solve(g, k=5)),
            ("uniondp", lambda: uniondp.solve(g, k=5))]
    return [(label, *timed(fn)) for label, fn in runs]


def same_rows(label, got, want) -> None:
    """Raise unless two ``ExecResult``s hold the same columns and rows."""
    if got.rels != want.rels or not torch.equal(got.rows.cpu(),
                                                want.rows.cpu()):
        raise AssertionError(f"{label}: {got.count} rows over {got.rels} vs "
                             f"{want.count} over {want.rels}")


def packed_preds(p, g) -> int:
    """The most predicates one join of plan p packs into one key."""
    if p.is_leaf:
        return 0
    a, b = p.left.rel_set, p.right.rel_set
    here = sum(1 for u, v in g.edges if ((a >> u) & (b >> v) & 1)
               or ((a >> v) & (b >> u) & 1))
    return max(here, packed_preds(p.left, g), packed_preds(p.right, g))


def true_rows(out, g, data) -> torch.Tensor:
    """The canonical rows of ``out`` that satisfy every predicate among its
    relations: a row that only a wrapped key matched fails one."""
    col = {v: i for i, v in enumerate(out.rels)}
    keep = torch.ones(out.count, dtype=torch.bool, device=out.rows.device)
    for e, (u, v) in enumerate(g.edges):
        if u in col and v in col:
            keep &= (data[u]["cols"][e][out.rows[:, col[u]]]
                     == data[v]["cols"][e][out.rows[:, col[v]]])
    return ex.ExecResult(out.rels, out.rows[keep]).canonical()


def same_result(label, g, data, a, b) -> str:
    """Raise unless two plans' results (``(plan, ExecResult)`` pairs) hold
    the same rows.  The executor packs a join's predicate keys into one
    int64 as the reference does, ``k * 2^20 + c``, which wraps and can
    collide where a join packs four or more: only there may the results
    differ, and then only in rows that fail a predicate (the reference's
    executor finds the same extra rows).  Returns a note on such rows."""
    (pa, ra), (pb, rb) = a, b
    if torch.equal(ra.canonical(), rb.canonical()):
        return ""
    packs = max(packed_preds(pa, g), packed_preds(pb, g))
    ta, tb = true_rows(ra, g, data), true_rows(rb, g, data)
    if packs < 4 or not torch.equal(ta, tb):
        raise AssertionError(f"{label}: {ra.count} rows ({ta.shape[0]} true) "
                             f"vs {rb.count} ({tb.shape[0]} true); a join "
                             f"packs at most {packs} predicates")
    return (f"{label}: rows equal after dropping {ra.count - ta.shape[0]} and "
            f"{rb.count - tb.shape[0]} rows that only a wrapped "
            f"{packs}-predicate key matched (the reference's packing)")


def run_fig10(label, g, max_rows):
    """One Fig. 10 part: the six optimizers' plans of ``g`` executed on the
    card on ``generate_data(max_rows, seed=1)``; the mpdp and dpccp plans'
    raw rows == the port's cpu executor's, every plan's ``canonical()``
    == the others'; one Fig. 10 line per plan."""
    plans = fig10_plans(g)
    oracle = next(r for a, r, _ in plans if a == "dpccp")
    data = ex.generate_data(g, max_rows=max_rows, seed=1)
    cpu_data = ex.generate_data(g, max_rows=max_rows, seed=1, device="cpu")
    torch.cuda.reset_peak_memory_stats()
    want, notes = None, []
    for algo, r, opt_s in plans:
        validate_plan(r.plan, g)
        if algo in ("mpdp", "dpsub") and rel(r.cost, oracle.cost) > 1e-4:
            raise AssertionError(f"{label} {algo}: cost {r.cost} vs DPccp "
                                 f"{oracle.cost}")
        with Intermediates() as spy:
            out = ex.execute(r.plan, g, data)
        if algo in ("mpdp", "dpccp"):
            same_rows(f"{label} {algo} cuda vs cpu", out,
                      ex.execute(r.plan, g, cpu_data))
        if want is None:
            want = (r.plan, out)
        else:
            notes.append(same_result(f"{label} n={g.n} {algo} vs mpdp", g,
                                     data, (r.plan, out), want))
        del out
        res, exec_s = ex.execute_timed(r.plan, g, data)
        log(f"fig10 {label} n={g.n} {algo}: {r.algorithm} cost {r.cost:.6g}; "
            f"opt_ms {1e3 * opt_s:.3f} exec_ms {1e3 * exec_s:.3f} "
            f"exec_over_opt {exec_s / opt_s:.4f}; rows {res.count}; largest "
            f"intermediate {spy.largest[0]} x {spy.largest[1]} = "
            f"{spy.largest[0] * spy.largest[1]} int64")
        del res
    del want
    for note in filter(None, notes):
        log(f"fig10 {note}")
    log(f"fig10 {label} n={g.n} max_rows={max_rows}: {len(plans)} plans valid "
        f"(mpdp, dpsub within 1e-4 of DPccp), canonical rows equal across "
        f"{', '.join(a for a, _, _ in plans)}; mpdp and dpccp raw rows == the "
        f"cpu executor's; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")


def k4_wrap():
    """K4 whose bushy plan's last join packs four predicates with key
    domains of 16, so its int64 keys wrap (``tests/test_torch_execution``
    holds the case against the reference)."""
    g = JoinGraph.make(4, [(0, 1), (2, 3), (0, 2), (0, 3), (1, 2), (1, 3)],
                       [1e4] * 4, [0.5, 0.5] + [1 / 16] * 4)
    leaves = [leaf_plan(v, g) for v in range(4)]
    return g, join_plans(join_plans(leaves[0], leaves[1], g),
                         join_plans(leaves[2], leaves[3], g), g)


def hyper_cpu_run():
    """e3 on ``device="cpu"`` and the host DPccp costs (a worker process)."""
    torch.set_num_threads(1)
    graphs = [gen.hypergraph_query(n, seed=s) for n, s in HYPER]
    g20 = gen.hypergraph_query(20, seed=0)
    many = batch.optimize_many(graphs, "auto", device="cpu")
    solo = engine.optimize(g20, "mpdp", device="cpu")
    return many, solo, [dpccp.solve(g).cost for g in graphs + [g20]]


def run_hyper(cpu_fut):
    """e3: hypergraph queries (chains plus lowered cliques, so cyclic)
    through ``optimize_many(auto)`` and solo ``optimize`` on the card, held
    against DPccp and the cpu run; each executed against GOO's plan."""
    graphs = [gen.hypergraph_query(n, seed=s) for n, s in HYPER]
    g20 = gen.hypergraph_query(20, seed=0)
    before = dict(ops.LAUNCHES)
    many, wall = timed(lambda: batch.optimize_many(graphs, "auto"))
    log(f"execute e3 hypergraph: {len(graphs)} queries (n 12-16, m "
        f"{min(g.m for g in graphs)}-{max(g.m for g in graphs)}) "
        f"{sorted({r.algorithm for r in many})} in {wall:.3f} s on cuda; "
        f"launches " + json.dumps({k: v - before[k] for k, v in
                                   ops.LAUNCHES.items() if v != before[k]}))
    check_bspan("execute e3 hypergraph", graphs, "auto", before)
    if {r.algorithm for r in many} != {"batch_mpdp_general"}:
        raise AssertionError("e3: not every hypergraph query ran in an "
                             "MPDP-general flight")
    before = dict(ops.LAUNCHES)
    solo, wall = timed(lambda: engine.optimize(g20, "mpdp"))
    log(f"execute e3 hypergraph n=20: m={g20.m} {solo.algorithm} in "
        f"{wall:.3f} s on cuda; counters {solo.counters}; launches "
        + json.dumps({k: v - before[k] for k, v in ops.LAUNCHES.items()
                      if v != before[k]}))
    got = ops.LAUNCHES["connectivity_span"] - before["connectivity_span"]
    if got != span_launches(g20):
        raise AssertionError(f"e3 n=20: {got} connectivity_span launches for "
                             f"{span_launches(g20)} level spans")
    cpu_many, cpu_solo, oracle = cpu_fut.result()
    worst = max(hold(f"execute e3 query {i}", g, r, c, o)
                for i, (g, r, c, o) in enumerate(zip(
                    graphs + [g20], many + [solo], cpu_many + [cpu_solo],
                    oracle)))
    rows = []
    for i, (g, r) in enumerate(zip(graphs + [g20], many + [solo])):
        data = ex.generate_data(g, max_rows=300, seed=i)
        out = ex.execute(r.plan, g, data)
        gp = goo.solve(g).plan
        note = same_result(f"e3 query {i} (n={g.n}) vs GOO's plan", g, data,
                           (r.plan, out), (gp, ex.execute(gp, g, data)))
        if note:
            log(f"execute {note}")
        rows.append(out.count)
    log(f"execute e3: {len(graphs) + 1} plans valid, costs within 1e-4 of "
        f"DPccp, match the cpu run (counters exact, max {worst} ulp); "
        f"executed at max_rows=300 ({rows} rows), canonical == GOO's plan's "
        f"(up to the collisions shown)")
    g, plan = k4_wrap()
    data = ex.generate_data(g, max_rows=250, seed=1)
    out = ex.execute(plan, g, data)
    same_rows("e3 k4 wrap cuda vs cpu", out, ex.execute(
        plan, g, ex.generate_data(g, max_rows=250, seed=1, device="cpu")))
    log(f"execute e3 k4 wrap: {out.count} rows over four packed predicates "
        f"(int64 keys wrap) == the cpu executor's")


def start_example(started, script, *args):
    """``examples/<script>`` as its own process (``PYTHONPATH=src``), added
    to ``started``, whose processes ``phase_execute`` stops at its end."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    started.append(subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE))
    return started[-1]


def example_output(label, proc) -> str:
    """Wait for an example; raise unless it exits 0."""
    out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{out}\n{err}")
    return out


def example_queries(label, out) -> list:
    """(index, n, algo, cost, rows, exact cost) of each query line."""
    qs = [m.groups() for m in map(QUERY_LINE.match, out.splitlines()) if m]
    if not qs:
        raise AssertionError(f"{label}: no query line in\n{out}")
    return qs


def same_queries(label, got, want, exact=False) -> int:
    """Raise unless the query lines agree: algo and rows equal, the exact
    cost equal (``exact``) or within 1e-5.  Returns the largest ulp."""
    worst = 0
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} vs {len(want)} queries")
    for a, b in zip(got, want):
        ca, cb = float(a[5]), float(b[5])
        if a[:3] + a[4:5] != b[:3] + b[4:5] or \
                (ca != cb if exact else rel(ca, cb) > 1e-5):
            raise AssertionError(f"{label}: {a} vs {b}")
        worst = max(worst, ulps(ca, cb))
    return worst


def run_examples(started, cpu_procs):
    """q1-q3: the port's examples as processes on the card, against their
    ``--device cpu`` runs (``cpu_procs``, started earlier)."""
    t0 = time.perf_counter()
    cache = build.BUILD_DIR / "q3.plancache"                  # gitignored
    cache.unlink(missing_ok=True)
    q3 = ("--queries", "6", "--pipeline", "--cache-file", str(cache))
    procs = {"q1": start_example(started, "quickstart_torch.py"),
             "q2": start_example(started, "query_service_torch.py",
                                 "--queries", "6"),
             "q3 first": start_example(started, "query_service_torch.py",
                                       *q3)}
    out = {k: example_output(f"example {k}", p) for k, p in procs.items()}
    out["q3 second"] = example_output("example q3 second", start_example(
        started, "query_service_torch.py", *q3))
    cpu = {k: example_output(f"example {k} --device cpu", p)
           for k, p in cpu_procs.items()}
    wall = time.perf_counter() - t0
    mask = (lambda s: re.sub(r"wall=\S+", "wall=", s).splitlines())
    if mask(out["q1"]) != mask(cpu["q1"]):
        raise AssertionError(f"q1: cuda output\n{out['q1']}\nvs cpu\n"
                             f"{cpu['q1']}")
    algo = re.search(r"algorithm\s*: (\S+)", out["q1"]).group(1)
    log(f"example q1 quickstart_torch.py: exit 0 on cuda, every line == the "
        f"--device cpu run's (host walls aside; {algo}, 14-relation "
        + re.search(r"MusicBrainz 14-rel: (cost=\S+ algo=\S+)",
                    out["q1"]).group(1) + ")")
    q2 = example_queries("q2", out["q2"])
    u = same_queries("q2 cuda vs cpu", q2, example_queries("q2 cpu",
                                                           cpu["q2"]))
    log(f"example q2 query_service_torch.py --queries 6: exit 0 on cuda; "
        f"algo, rows == the --device cpu run's, costs within 1e-5 (max {u} "
        f"ulp): " + "; ".join(f"Q{i} n={n} {a} cost {c} rows {r}"
                              for i, n, a, _, r, c in q2))
    first = example_queries("q3 first", out["q3 first"])
    same_queries("q3 first vs q2", first, q2, exact=True)
    second = example_queries("q3 second", out["q3 second"])
    hits = [(i, n, f"cache[{a}]" if int(n) <= 14 else a, c4, r, c)
            for i, n, a, c4, r, c in q2]
    n_exact = sum(int(q[1]) <= 14 for q in q2)
    if f"plan cache {n_exact} hits / 0 misses" not in out["q3 second"]:
        raise AssertionError(f"q3 second run:\n{out['q3 second']}")
    u = same_queries("q3 second vs q2", second, hits)
    log(f"example q3 --pipeline --cache-file: first run == q2 (cost ==, "
        f"algo, rows), second run {n_exact} hits / 0 misses, every "
        f"exact-tier query served from the cache with q2's rows and its "
        f"cost within 1e-5 (a hit is re-costed on the host; max {u} ulp); "
        f"examples {wall:.1f} s (processes in parallel)")


def phase_execute():
    """The optimize-and-execute path on the card: e1 (Fig. 10), e2 (larger
    data), e3 (hypergraph queries), launch counters read around exactly
    them, and a profile of e1's n = 10 execution; then q1-q3, the port's
    examples in their own processes.  The cpu runs of e3 and of the
    examples go on meanwhile, after e1 and e2 are timed.  Returns the
    launches."""
    t_start = time.perf_counter()
    started = []
    try:
        ops.reset_launches()
        with ChunkCalls() as chunks:
            for n in FIG10:
                run_fig10("e1", gen.musicbrainz_query(n, seed=n), FIG10_ROWS)
            run_fig10("e2", gen.musicbrainz_query(12, seed=12), E2_ROWS)
            log(f"execute e1, e2: {time.perf_counter() - t_start:.1f} s")
            spawn = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=1, mp_context=spawn) as pool:
                cpu_fut = pool.submit(hyper_cpu_run)
                cpu_procs = {
                    "q1": start_example(started, "quickstart_torch.py",
                                        "--device", "cpu"),
                    "q2": start_example(started, "query_service_torch.py",
                                        "--queries", "6", "--device", "cpu")}
                run_hyper(cpu_fut)
        exe = dict(ops.LAUNCHES)
        log("launches on the execute path: " + json.dumps(exe))
        check_path("execute", exe, EXEC_PATH, chunks.count)
        g = gen.musicbrainz_query(10, seed=10)
        plan = engine.optimize(g, "mpdp").plan
        data = ex.generate_data(g, max_rows=FIG10_ROWS, seed=1)
        ex.execute(plan, g, data)
        profile("execute e1 n=10 mpdp", lambda: ex.execute(plan, g, data), ())
        del data
        run_examples(started, cpu_procs)
    finally:
        for proc in started:
            proc.kill()
            proc.wait()
    log(f"execute path (phase 11): {time.perf_counter() - t_start:.1f} s")
    return exe


# --------------------------------------------------------------- phase 12 --

M1_ARGV = ["--arch", "gemma3_12b", "--batch", "4", "--prompt-len", "1040",
           "--gen", "16", "--max-len", "1152", "--seed", "0"]
DECODE_ARCHS = ("starcoder2_3b", "mamba2_370m", "recurrentgemma_9b",
                "deepseek_v2_lite")       # tests/test_models.py's four
# The MLA bounds (corr > 0.99, rel < 0.015) hold for some random draws and
# not others, in the reference as in the port (ROADMAP queue 3): the check
# is held at one seed and printed for four.
DECODE_SEEDS = (0, 1, 2, 3)
DECODE_SEED = 3


def agreement(a, b):
    """(corr, mean |a - b| / max(max |a|, 1), max |a - b|) in f32."""
    a = a.detach().float().cpu().numpy().ravel()
    b = b.detach().float().cpu().numpy().ravel()
    d = np.abs(a - b)
    return (float(np.corrcoef(a, b)[0, 1]), float(d.mean() / max(np.abs(a).max(),
                                                                 1.0)),
            float(d.max()))


def hold_close(label, want, got, corr_min, rel_max) -> str:
    """Raise unless ``got`` agrees with ``want`` within the bounds."""
    corr, rel_, worst = agreement(want, got)
    if not (np.isfinite(got.float().cpu().numpy()).all() and corr > corr_min
            and rel_ < rel_max):
        raise AssertionError(f"{label}: corr {corr:.6f} (> {corr_min}), rel "
                             f"{rel_:.3e} (< {rel_max}), max |diff| {worst}")
    return f"corr {corr:.6f} rel {rel_:.3e} max |diff| {worst:.4g}"


def serve_m1():
    """m1: gemma3_12b at full width through ``launch.serve.run``; its
    prefill against the decode loop at the last prompt position (printed),
    a profile of one decode step; then the same model computing in f32,
    its decode loop held against its prefill past the ring wrap."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve.run(M1_ARGV)
    peak_run = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    cfg, B = res.cfg, res.prompt.shape[0]
    S, gen_n = res.prompt.shape[1], res.tokens.shape[1]
    max_len = int(M1_ARGV[M1_ARGV.index("--max-len") + 1])
    w_bytes = api.tree_bytes(res.params)
    c_bytes = api.tree_bytes(res.cache)
    bound_ms = (w_bytes + c_bytes) / roofline.HBM_BW * 1e3
    steps = np.asarray(res.step_ms)
    med = float(np.median(steps[1:]))
    log(f"serve m1 gemma3_12b full width ({cfg.param_count() / 1e9:.2f} B "
        f"params, {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}) "
        f"on cuda: batch {B}, prompt {S}, gen {gen_n}; {len(steps)} decode "
        f"steps in {res.seconds:.3f} s = {B * (S + gen_n) / res.seconds:.1f} "
        f"tokens/s; step ms by CUDA events: median {med:.3f}, first "
        f"{steps[0]:.3f}, p10 {np.percentile(steps[1:], 10):.3f}, p90 "
        f"{np.percentile(steps[1:], 90):.3f}; weights {w_bytes} B read a step, "
        f"cache {c_bytes} B; bound (weights + cache) / 3.35 TB/s "
        f"{bound_ms:.3f} ms, median / bound {med / bound_ms:.2f}; "
        f"max_memory_allocated {peak_run} B (f32 init included), held "
        f"{held} B")
    log("serve m1 sample: " + str(res.tokens[0][:12].tolist()))
    if not torch.isfinite(res.logits).all():
        raise AssertionError("serve m1: non-finite logits")
    torch.cuda.reset_peak_memory_stats()
    prefill = api.make_prefill_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = prefill(res.params, {"tokens": res.prompt})
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    corr, rel_, worst = agreement(pre, res.prompt_logits)
    same = int((pre.argmax(-1) == res.prompt_logits.argmax(-1)).sum())
    # the bf16 noise floor: the same prefill, its GEMMs tiled for one row
    # instead of four, at 64 tokens
    short = res.prompt[:, :64]
    floor = agreement(prefill(res.params, {"tokens": short}), torch.cat(
        [prefill(res.params, {"tokens": short[i: i + 1]}) for i in range(B)]))
    log(f"serve m1 prefill ({B} x {S}, make_prefill_step, bf16) {pre_s:.3f} "
        f"s, max_memory_allocated {torch.cuda.max_memory_allocated()} B; its "
        f"last logits vs the decode loop's at position {S - 1} (local rings "
        f"of {min(w for w in cfg.window_pattern if w)} slots wrapped): corr "
        f"{corr:.6f} rel {rel_:.3e} max |diff| "
        f"{worst:.4g}, argmax equal in {same} of {B} rows; bf16 noise floor, "
        f"prefill of 64 tokens batched vs row by row: corr {floor[0]:.6f} "
        f"rel {floor[1]:.3e} max |diff| {floor[2]:.4g}")
    tok = torch.argmax(res.logits, -1).to(torch.int32)[:, None]
    pos = S + gen_n - 1
    busy = profile("serve m1 one decode step",
                   lambda: res.model.decode_step(res.params, res.cache, tok, pos),
                   ())
    log(f"serve m1 one decode step: the card idle {1 - busy:.4f} of the "
        f"profiled window (between and around its launches)")
    prompt = res.prompt
    del res, pre
    torch.cuda.empty_cache()
    serve_m1_f32(cfg, prompt, max_len)


def serve_m1_f32(cfg, prompt, max_len: int):
    """gemma3_12b at full width computing in f32, from the f32 masters the
    serving run drew (the same seed): the decode loop over the prompt
    against the prefill's last logits, within
    test_local_window_ring_cache_consistency's bounds (corr > 0.999, rel
    < 0.01).  In bf16 the two round differently and 48 random layers
    amplify it past those bounds (printed above)."""
    seed = int(M1_ARGV[M1_ARGV.index("--seed") + 1])
    t0 = time.perf_counter()
    model = api.build_model(cfg, torch.float32)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(seed))
    cache = model.init_cache(prompt.shape[0], max_len, device=DEV)
    for t in range(prompt.shape[1]):
        dec, cache = model.decode_step(params, cache, prompt[:, t: t + 1], t)
    pre = model.forward(params, prompt, last_only=True)[0][:, -1]
    got = hold_close("serve m1 f32 prefill vs decode at position "
                     f"{prompt.shape[1] - 1}", pre, dec, 0.999, 0.01)
    log(f"serve m1 f32: decode loop ({prompt.shape[1]} steps) vs prefill at "
        f"position {prompt.shape[1] - 1}: {got}; {time.perf_counter() - t0:.1f} "
        f"s, max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    del params, cache
    torch.cuda.empty_cache()


def reduced_cfgs():
    """(label, config) of every arch at reduced(), MoE also at a dropless
    capacity factor."""
    out = []
    for arch in api.ARCH_IDS:
        cfg = api.get_config(arch).reduced()
        out.append((arch, cfg))
        if cfg.moe:
            out.append((f"{arch} cap 8", dataclasses.replace(cfg, moe_cap_factor=8.0)))
    return out


def model_inputs(cfg, B: int, S: int, seed: int) -> dict:
    """Tokens from numpy; encdec frames zero (the reference tests' batch),
    vlm patch embeddings from numpy."""
    r = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        r.integers(1, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, 16, cfg.frame_dim), dtype=torch.bfloat16)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(r.standard_normal(
            (B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)).bfloat16()
    return batch


def model_outputs(cfg, params, batch, device, steps: int = 10):
    """(forward logits, stacked logits of ``steps`` decode steps from
    init_cache(B, 32), prefill logits) of the port on ``device``."""
    model = api.build_model(cfg)
    b = {k: v.to(device) for k, v in batch.items()}
    toks = b["tokens"]
    if cfg.family == "encdec":
        fwd = model.decode_stack(params, toks, model.encode(params, b["frames"]))
    elif cfg.family == "vlm":
        fwd = model.forward(params, toks, b["patch_embeds"])[0]
    elif cfg.family in ("dense", "moe"):
        fwd = model.forward(params, toks)[0]
    else:
        fwd = model.forward(params, toks)
    cache = model.init_cache(toks.shape[0], 32, device=device)
    dec = []
    for t in range(steps):
        lg, cache = model.decode_step(params, cache, toks[:, t: t + 1], t)
        dec.append(lg)
    pre = api.make_prefill_step(cfg)(params, b)
    return fwd, torch.stack(dec, dim=1), pre


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def decode_vs_forward(cfg, seed: int):
    """tests/test_models.py's decode-vs-forward check on the card: params
    from ``torch.Generator(cuda).manual_seed(seed)``, (2, 10) tokens from
    numpy; (corr, rel, argmax agreement)."""
    model = api.build_model(cfg)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(seed))
    B, T = 2, 10
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (B, T)).astype(np.int32)).to(DEV)
    full = model.forward(params, toks)
    full = full[0] if cfg.family in ("dense", "moe") else full
    cache = model.init_cache(B, 32, device=DEV)
    dec = []
    for t in range(T):
        lg, cache = model.decode_step(params, cache, toks[:, t: t + 1], t)
        dec.append(lg)
    dec = torch.stack(dec, dim=1)
    corr, rel_, _ = agreement(full, dec)
    return corr, rel_, float((full.argmax(-1) == dec.argmax(-1)).float().mean())


def serve_m2():
    """m2: every arch at reduced() on cuda against the port's cpu run from
    the same params (the whole-model bounds of tests/test_torch_models.py);
    then tests/test_models.py's decode-vs-forward check on the card."""
    t0 = time.perf_counter()
    for label, cfg in reduced_cfgs():
        model = api.build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(1))
        batch = model_inputs(cfg, 2, 32, seed=2)
        cpu = model_outputs(cfg, params, batch, "cpu")
        card = model_outputs(cfg, to_device(params, DEV), batch, DEV)
        mla = cfg.mla
        lims = (0.99, 0.015) if mla else (0.998, 0.01)
        parts = [f"{what} " + hold_close(f"serve m2 {label} {what}", a, b, *lims)
                 for what, a, b in zip(("forward", "decode x10", "prefill"),
                                       cpu, card)]
        log(f"serve m2 {label} cuda vs cpu: " + "; ".join(parts))
    for arch in DECODE_ARCHS:
        cfg = api.get_config(arch).reduced()
        if cfg.moe:
            cfg = dataclasses.replace(cfg, moe_cap_factor=8.0)
        lims = (0.99, 0.015) if cfg.mla else (0.998, 0.01)
        seen = []
        for seed in DECODE_SEEDS:
            corr, rel_, agree = decode_vs_forward(cfg, seed)
            seen.append(f"seed {seed}: corr {corr:.6f} rel {rel_:.3e} "
                        f"argmax agreement {agree:.3f}")
            ok = corr > lims[0] and rel_ < lims[1] and \
                ((agree >= 0.85) if cfg.mla else (agree > 0.85))
            if seed == DECODE_SEED and not ok:
                raise AssertionError(f"serve m2 decode vs forward {arch}: "
                                     + seen[-1])
        log(f"serve m2 decode vs forward {arch} on cuda (bounds corr > "
            f"{lims[0]}, rel < {lims[1]}, held at seed {DECODE_SEED}): "
            + "; ".join(seen))
    log(f"serve m2: {time.perf_counter() - t0:.1f} s")


def serve_m3(started):
    """m3: ``examples/serve_lm_torch.py`` as a process on the card."""
    t0 = time.perf_counter()
    out = example_output("example serve_lm_torch.py", start_example(
        started, "serve_lm_torch.py"))
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
    if len(lines) != 2:
        raise AssertionError(f"serve m3: no [serve] lines in\n{out}")
    log(f"serve m3 examples/serve_lm_torch.py: exit 0 on cuda in "
        f"{time.perf_counter() - t0:.1f} s: " + " | ".join(lines))


def phase_serve():
    """The LM serving path on the card: m1 (gemma3_12b at full width), m2
    (every arch at reduced() against the cpu), m3 (the example as a
    process).  Launch counters read around exactly m1-m3: the path runs
    none of the kernels.  Returns the launches."""
    t_start = time.perf_counter()
    started = []
    try:
        ops.reset_launches()
        serve_m1()
        serve_m2()
        serve_m3(started)
        srv = dict(ops.LAUNCHES)
    finally:
        for proc in started:
            proc.kill()
            proc.wait()
    log("launches on the serve path: " + json.dumps(srv))
    if any(srv.values()):
        raise AssertionError(f"serve path: launches {srv}; the LM path runs "
                             f"none of the kernels")
    log(f"serve path (phase 12): {time.perf_counter() - t_start:.1f} s")
    return srv


# --------------------------------------------------------------- phase 13 --

R1_ARCH = "mamba2_370m"
R1_SEQ = SHAPES["train_4k"].seq_len              # 4,096
R1_BATCH = SHAPES["train_4k"].global_batch // 16  # one of 16 data ranks: 16
R1_MICRO = 2                                      # microbatches of 8
R1_STEPS = 6
R1_DET_STEPS = 4                                  # deterministic, as launch.train
R1_DET_FLAG = "--train-r1-deterministic"          # the subprocess that runs them
R2_SEQ = 256
R5_ARGS = ["--arch", "mamba2_370m", "--reduced", "--steps", "12", "--batch",
           "2", "--seq", "32", "--ckpt-every", "4", "--log-every", "50"]


def leaf_corr(a: dict, b: dict):
    """(whole-tree corr, worst leaf, its corr) of two gradient trees, from
    float64 moment sums on the card (368 M elements a tree at full
    width)."""
    def moments(x, y):
        x = x.detach().to(DEV, torch.float64).ravel()
        y = y.detach().to(DEV, torch.float64).ravel()
        return torch.stack([torch.tensor(float(x.numel()), dtype=torch.float64,
                                         device=DEV), x.sum(), y.sum(),
                            (x * x).sum(), (y * y).sum(), (x * y).sum()])

    def corr(m):
        n, sx, sy, sxx, syy, sxy = (float(v) for v in m)
        vx, vy = n * sxx - sx * sx, n * syy - sy * sy
        if vx <= 0 or vy <= 0:
            return 1.0 if vx == vy == 0 else 0.0
        return (n * sxy - sx * sy) / np.sqrt(vx * vy)
    per = {p: moments(x, y) for (p, x), (_, y) in zip(leaves_with_path(a),
                                                      leaves_with_path(b))}
    worst = min(per, key=lambda p: corr(per[p]))
    return corr(sum(per.values())), worst, corr(per[worst])


def profile_step(label: str, fn) -> None:
    """One call of fn under the profiler (device activity): the card's busy
    share of the window and the top device operations by time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = device_events(prof)
    spans, by_name = [], {}
    for name, _, a, b in events:
        spans.append((a, b))
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + b - a)
    busy, cur = 0.0, None
    for a, b in sorted(spans):                    # the union of the spans
        if cur is not None and a <= cur[1]:
            cur[1] = max(cur[1], b)
            continue
        if cur is not None:
            busy += cur[1] - cur[0]
        cur = [a, b]
    if cur is not None:
        busy += cur[1] - cur[0]
    log(f"profile {label}: wall {wall:.3f} s (profiler on, device activity "
        f"only), {len(events)} device events, device busy {busy / 1e6:.3f} s "
        f"= {busy / 1e6 / wall:.4f} of the window, idle "
        f"{1 - busy / 1e6 / wall:.4f}")
    for key, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"profile  {us / 1e3:10.2f} ms {n:7d} x  {key[:100]}")


def step_times(label, step, state, data, first: int, n: int):
    """Run ``n`` steps from batch ``first``: (state, losses, grad norms,
    each step's ms by CUDA events)."""
    losses, norms, ms = [], [], []
    for i in range(first, first + n):
        batch = {k: v.to(DEV) for k, v in data.batch_at(i).items()}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        b.synchronize()
        ms.append(a.elapsed_time(b))
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"{label}: losses {losses}, grad norms {norms}")
    return state, losses, norms, ms


def r1_setup():
    """r1's config, state (weights from torch.Generator(cuda).manual_seed(0)),
    step (2 microbatches) and data."""
    cfg = api.get_config(R1_ARCH)
    if not cfg.remat:
        raise AssertionError("train r1: the full config must rematerialize")
    model = api.build_model(cfg)
    state = init_train_state(model.init_params(
        torch.Generator(device=DEV).manual_seed(0)))
    step = api.make_train_step(cfg, microbatches=R1_MICRO)
    return cfg, state, step, SyntheticLM(cfg.vocab, R1_SEQ, R1_BATCH, seed=0)


def train_r1():
    """r1: mamba2_370m at full width (48 layers, d 1,024, vocab 50,280,
    remat on, f32 masters, bf16 compute), seq 4,096, global batch 16 as 2
    microbatches of 8 from SyntheticLM(seed=0): 6 steps as
    ``make_train_step`` runs them, then a profiled step.  Returns the
    state."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, state, step, data = r1_setup()
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    state, losses, norms, ms = step_times("train r1", step, state, data, 0,
                                          R1_STEPS)
    peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    tokens = R1_BATCH * R1_SEQ
    n_active = cfg.active_param_count()
    bound_s = 6 * n_active * tokens / roofline.PEAK_FLOPS
    warm = np.asarray(ms[1:])
    med = float(np.median(warm))
    log(f"train r1 {R1_ARCH} full width ({n_params} params, {cfg.n_layers} "
        f"layers, d {cfg.d_model}, vocab {cfg.vocab}, remat on, f32 masters, "
        f"bf16 compute) on cuda: seq {R1_SEQ}, global batch {R1_BATCH} as "
        f"{R1_MICRO} microbatches of {R1_BATCH // R1_MICRO}; {R1_STEPS} "
        f"steps, losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]}; step ms by CUDA events: first "
        f"{ms[0]:.1f}, median {med:.1f}, p90 {np.percentile(warm, 90):.1f} "
        f"(steps 2-{R1_STEPS}); {tokens / (med / 1e3):.1f} tokens/s; bound 6 x "
        f"{n_active} x {tokens} / 989.4 TFLOP/s = {bound_s * 1e3:.1f} ms "
        f"(remat's recompute not counted), median / bound "
        f"{med / 1e3 / bound_s:.2f}; max_memory_allocated {peak} B, held "
        f"{held} B (state {api.tree_bytes(state)} B); setup "
        f"{time.perf_counter() - t0 - sum(ms) / 1e3:.1f} s")
    batch = {k: v.to(DEV) for k, v in data.batch_at(0).items()}
    holder = [state]

    def one():
        holder[0], _ = step(holder[0], batch)
    profile_step("train r1 one step", one)
    return holder[0], losses, med


def r1_deterministic_worker() -> int:
    """The body of ``chip_smoke.py --train-r1-deterministic``: r1's first
    steps with the trainer's deterministic kernels
    (``launch.train.deterministic``; the parent sets cuBLAS's workspace
    variable before this process starts, so the other phases run without
    it).  Prints one JSON line: losses, grad norms, step ms, launches."""
    trainer.deterministic(DEV)
    ops.reset_launches()
    _, state, step, data = r1_setup()
    _, losses, norms, ms = step_times("train r1 deterministic", step, state,
                                      data, 0, R1_DET_STEPS)
    print(json.dumps({"losses": losses, "norms": norms, "ms": ms,
                      "launches": dict(ops.LAUNCHES)}))
    return 0


def train_r1_deterministic(started, losses, med: float) -> dict:
    """r1's first steps again, deterministic, in a process of their own
    (``r1_deterministic_worker``): its step time against r1's median and
    its losses beside r1's.  Returns the process's launches."""
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    started.append(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), R1_DET_FLAG], cwd=ROOT,
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out, err = started[-1].communicate(timeout=EXAMPLE_TIMEOUT_S)
    if started[-1].returncode != 0:
        raise AssertionError(f"train r1 deterministic: exit "
                             f"{started[-1].returncode}\n{out}\n{err}")
    got = json.loads(out.strip().splitlines()[-1])
    ms = got["ms"]
    det = float(np.median(ms[1:]))
    log(f"train r1 deterministic (torch.use_deterministic_algorithms, "
        f"CUBLAS_WORKSPACE_CONFIG=:4096:8, own process): {R1_DET_STEPS} "
        f"steps, losses {[round(x, 4) for x in got['losses']]} (r1's "
        f"{[round(x, 4) for x in losses[:R1_DET_STEPS]]}), step ms "
        f"{[round(x, 1) for x in ms]}, median {det:.1f} (steps 2-"
        f"{R1_DET_STEPS}) against r1's {med:.1f}: {det / med - 1:+.2%}; "
        f"{time.perf_counter() - t0:.1f} s with the process's start")
    return got["launches"]


def train_r2():
    """r2: the full-width model computing in f32, weights drawn once on the
    host and copied to the card: one loss and its gradients (B 1, S 256)
    on cuda and on cpu; loss within a relative 1e-4, whole-tree grad corr
    >= 0.9999."""
    t0 = time.perf_counter()
    cfg = api.get_config(R1_ARCH)
    model = api.build_model(cfg, torch.float32)
    params = model.init_params(torch.Generator().manual_seed(1))
    batch = SyntheticLM(cfg.vocab, R2_SEQ, 1, seed=1).batch_at(0)
    t1 = time.perf_counter()
    l_cpu, g_cpu = api.loss_and_grads(model, params, batch)
    t2 = time.perf_counter()
    l_gpu, g_gpu = api.loss_and_grads(model, to_device(params, DEV),
                                      to_device(batch, DEV))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    rel_ = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    whole, worst, wc = leaf_corr(g_cpu, g_gpu)
    log(f"train r2 {R1_ARCH} full width in f32 (B 1, S {R2_SEQ}): loss cuda "
        f"{float(l_gpu)!r} cpu {float(l_cpu)!r} (rel {rel_:.3e}, bound 1e-4); "
        f"grads whole-tree corr {whole:.7f} (bound 0.9999), worst leaf {worst} "
        f"corr {wc:.7f}; {time.perf_counter() - t0:.1f} s (draw {t1 - t0:.1f}, "
        f"cpu loss and grads {t2 - t1:.1f} on {torch.get_num_threads()} "
        f"threads, cuda {t3 - t2:.1f}, compare {time.perf_counter() - t3:.1f})")
    if not (rel_ < 1e-4 and whole >= 0.9999):
        raise AssertionError(f"train r2: rel {rel_}, corr {whole}")


def train_r3(state):
    """r3: r1's state saved (the trainer's async writer) and restored bit
    for bit; seconds and bytes on disk; then deleted."""
    d = tempfile.mkdtemp(prefix="train_r3_")
    try:
        ck = CheckpointManager(d, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(int(state["step"]), state)
        t_host = time.perf_counter() - t0
        ck.wait()
        t_save = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(d) for f in fs)
        t0 = time.perf_counter()
        back, step = ck.restore(state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(a, b) and a.dtype == b.dtype and a.device == b.device
                   for (_, a), (_, b) in zip(leaves_with_path(state),
                                             leaves_with_path(back)))
        log(f"train r3 checkpoint of r1's state ({api.tree_bytes(state)} B, "
            f"{len(tree_leaves(state))} leaves, step {step}): save {t_save:.2f} "
            f"s ({t_host:.2f} s to the host, the rest on the writer thread), "
            f"{on_disk} B on disk; restore to cuda {t_restore:.2f} s; bit for "
            f"bit: {same}")
        if not same:
            raise AssertionError("train r3: restored state differs")
        del back
    finally:
        shutil.rmtree(d, ignore_errors=True)


def train_r4():
    """r4: every arch at reduced(), weights drawn once on the host and
    copied: 8 steps on a fixed batch on cuda lower the loss, and step 0's
    loss is within 1 % of the cpu run's."""
    t0 = time.perf_counter()
    for arch in api.ARCH_IDS:
        cfg = api.get_config(arch).reduced()
        model = api.build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(2))
        batch = SyntheticLM(cfg.vocab, 32, 2, seed=2).batch_at(0)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((2, 32, cfg.frame_dim), dtype=torch.bfloat16)
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.from_numpy(
                np.random.default_rng(2).standard_normal(
                    (2, cfg.n_patches, cfg.patch_dim)).astype(np.float32)).bfloat16()
        step = api.make_train_step(cfg)
        _, m = step(init_train_state(params), batch)
        cpu = float(m["loss"])
        state = init_train_state(to_device(params, DEV))
        gb = to_device(batch, DEV)
        losses = []
        for _ in range(8):
            state, m = step(state, gb)
            losses.append(float(m["loss"]))
        rel_ = abs(losses[0] - cpu) / abs(cpu)
        log(f"train r4 {arch}: cuda losses {[round(x, 4) for x in losses]}; "
            f"step 0 vs the cpu run's {cpu:.6f}: rel {rel_:.3e}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                and rel_ <= 0.01):
            raise AssertionError(f"train r4 {arch}: {losses}, cpu {cpu}")
    log(f"train r4: {time.perf_counter() - t0:.1f} s")


def train_r5(started):
    """r5: ``python -m repro_torch.launch.train`` on the card: crashed at
    step 6 and resumed from step 4, its final loss text equal to the
    uninterrupted run's; then ``examples/train_tiny_lm_torch.py``."""
    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="train_r5_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")

    def start(args):
        started.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *R5_ARGS, *args],
            cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
        return started[-1]

    def finish(label, proc, rc=0):
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
        if proc.returncode != rc:
            raise AssertionError(f"{label}: exit {proc.returncode}\n{out}\n{err}")
        return out

    try:
        example = start_example(started, "train_tiny_lm_torch.py", "--ckpt-dir",
                                os.path.join(d, "ex"))
        gold_p = start(["--ckpt-dir", os.path.join(d, "a")])
        crash = finish("train r5 crash", start(["--ckpt-dir",
                                                os.path.join(d, "b"),
                                                "--crash-at", "6"]), 17)
        resumed = finish("train r5 resume", start(["--ckpt-dir",
                                                   os.path.join(d, "b"),
                                                   "--resume"]))
        gold = finish("train r5 uninterrupted", gold_p).strip().splitlines()[-1]
        got = resumed.strip().splitlines()[-1]
        if "resumed from step 4" not in resumed or \
                gold.split("->")[-1] != got.split("->")[-1]:
            raise AssertionError(f"train r5: {gold!r} vs {got!r}\n{crash}\n{resumed}")
        log(f"train r5 launch.train on cuda: crashed after step 6 (exit 17), "
            f"resumed from step 4: {got!r} == the uninterrupted run's "
            f"{gold!r}")
        out = example_output("train r5 example", example)
        lines = [ln for ln in out.splitlines() if ln.startswith("[train]")]
        log(f"train r5 examples/train_tiny_lm_torch.py: exit 0 on cuda: "
            + " | ".join(lines[-2:]) + f"; r5 {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_train():
    """The training path on the card: r1-r5.  Launch counters read around
    exactly r1-r5: the path runs none of the kernels.  Returns the
    launches."""
    t_start = time.perf_counter()
    started = []
    try:
        ops.reset_launches()
        state, losses, med = train_r1()
        train_r3(state)
        del state
        torch.cuda.empty_cache()
        det = train_r1_deterministic(started, losses, med)
        train_r2()
        train_r4()
        train_r5(started)
        trn = {k: n + det.get(k, 0) for k, n in ops.LAUNCHES.items()}
    finally:
        for proc in started:
            proc.kill()
            proc.wait()
    log("launches on the train path: " + json.dumps(trn))
    if any(trn.values()):
        raise AssertionError(f"train path: launches {trn}; the training path "
                             f"runs none of the kernels")
    log(f"train path (phase 13): {time.perf_counter() - t_start:.1f} s")
    return trn


# --------------------------------------------------------------- phase 14 --

Y1_STEPS = 3                     # timed steps after the counting run
Y2_ARCH = "gemma3_12b"           # m1's model, batch, cache length
Y2_BATCH, Y2_LEN, Y2_POS = 4, 1152, 1040
Y2_STEPS = 10
PEAK_RATIO = (0.5, 1.05)         # predicted peak over max_memory_allocated
# y3: run_cell on the single-pod mesh, the cells that fit the phase's
# 180 s: all ten archs' decode_32k and mamba2_370m's prefill_32k, about a
# second each on meta and 6.6 s; every other train_4k and prefill_32k
# cell takes 0.5-5 minutes there (seamless_m4t_medium's prefill_32k
# 121.5 s on the card's host, PERF.md)
Y3_CELLS = [(a, "decode_32k") for a in api.ARCH_IDS] + [
    ("mamba2_370m", "prefill_32k")]
Y3_LEFT = [(a, s) for a in api.ARCH_IDS for s in ("train_4k", "prefill_32k",
                                                  "decode_32k")
           if (a, s) not in Y3_CELLS]


MESH_1X1 = Mesh((1, 1), ("data", "model"))
Y_CELLS = {   # label: (arch, shape, dry-run keywords)
    "y1": (R1_ARCH, dataclasses.replace(SHAPES["train_4k"], name="r1",
                                        seq_len=R1_SEQ, global_batch=R1_BATCH),
           {"microbatches": R1_MICRO}),
    "y2": (Y2_ARCH, dataclasses.replace(SHAPES["decode_32k"], name="m1",
                                        seq_len=Y2_LEN, global_batch=Y2_BATCH),
           {"pos": Y2_POS}),
}


def dry_meta(label: str):
    """The dry-run's side of phase 14 (in a worker process, no card):
    ``_measure`` of y1 or y2 on ``Mesh((1, 1))`` (its counting run's
    outputs dropped), or ``run_cell`` of each y3 cell ("y3")."""
    torch.set_num_threads(1)
    if label == "y3":
        return [dryrun.run_cell(a, s, "single") for a, s in Y3_CELLS]
    arch, shape, kw = Y_CELLS[label]
    m = dryrun._measure(api.get_config(arch), shape, MESH_1X1, **kw)
    del m["counted"]
    return m


def same_layout(label, meta_args, card_args) -> None:
    """Raise unless the card's arguments have the meta ones' structure,
    shapes and dtypes."""
    want = [(tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
            for t in dryrun._flat(meta_args)]
    got = [(tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
           for t in dryrun._flat(card_args)]
    if want != got:
        raise AssertionError(f"{label}: the card's arguments {got} differ from "
                             f"the meta cell's {want}")


def dry_hold(label, cell_label, meta, card_args, pos_bytes: int,
             steps: int) -> None:
    """One cell's step on the card's arguments under the dry-run's counters,
    held against its meta measurement (``meta``, a future of
    ``dry_meta(cell_label)``): FLOPs and bytes accessed equal, argument
    bytes equal the card's, the predicted peak over
    ``max_memory_allocated`` inside ``PEAK_RATIO``, the roofline bound at
    most the measured median step (CUDA events).  ``card_args`` builds
    the arguments on the card, so the peak is read above the bytes
    allocated before them."""
    arch, shape, kw = Y_CELLS[cell_label]
    cell = dryrun.lower_cell(api.get_config(arch), shape, MESH_1X1, shape.kind,
                             **kw)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    args = card_args()
    build_s = time.perf_counter() - t0
    same_layout(label, cell.args, args)
    arg_bytes = sum(x.numel() * x.element_size() for x in dryrun._flat(args)
                    if isinstance(x, torch.Tensor)) + pos_bytes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card = dryrun.count(cell.fn, args, DEV)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del card["out"]
    ms = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = cell.fn(*args)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        del out
    med = float(np.median(ms))
    m = meta.result()
    tot = m["totals"]
    terms = roofline.roofline_terms(m["flops"], m["bytes_accessed"],
                                    m["collectives"]["total"], 1)
    bound_ms = terms["step_s_lower_bound"] * 1e3
    ratio = tot["peak_bytes"] / peak
    log(f"dry-run {label} on Mesh((1, 1)): meta {tot['flops']} FLOPs, "
        f"{tot['bytes_accessed']} B accessed (counting run {m['compile_s']} s "
        f"in a worker process) == cuda {card['flops']} FLOPs, "
        f"{card['bytes_accessed']} B (counting run {card['seconds']:.1f} s); "
        f"arguments {m['memory']['argument_size_in_bytes']} B == the card's "
        f"{arg_bytes} B (built in {build_s:.1f} s); predicted peak "
        f"{tot['peak_bytes']} B (temp {m['memory']['temp_size_in_bytes']} B), "
        f"the card's max_memory_allocated {peak} B above the {base} B held "
        f"before, ratio {ratio:.4f} (inside {PEAK_RATIO}); roofline compute "
        f"{terms['compute_s'] * 1e3:.3f} ms, memory "
        f"{terms['memory_s'] * 1e3:.3f} ms, bound {bound_ms:.3f} ms "
        f"({terms['bottleneck']}) against the measured median "
        f"{med:.3f} ms ({steps} steps by CUDA events {[round(x, 3) for x in ms]}),"
        f" measured / bound {med / bound_ms:.3f}")
    bad = []
    if (tot["flops"], tot["bytes_accessed"]) != (card["flops"],
                                                 card["bytes_accessed"]):
        bad.append("meta and cuda counts differ")
    if m["memory"]["argument_size_in_bytes"] != arg_bytes:
        bad.append("argument bytes differ from the card's")
    if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
        bad.append(f"peak ratio {ratio:.4f} outside {PEAK_RATIO}")
    if bound_ms > med:
        bad.append(f"bound {bound_ms:.3f} ms above the measured {med:.3f} ms")
    if bad:
        raise AssertionError(f"dry-run {label}: " + "; ".join(bad))


def dry_y1(meta) -> None:
    """y1: r1's cell (mamba2_370m at full width, seq 4,096, global batch 16
    as 2 microbatches, remat on, weights from the seed r1 draws them
    with, SyntheticLM's first batch)."""
    def build():
        _, state, _, data = r1_setup()
        return state, {k: v.to(DEV) for k, v in data.batch_at(0).items()}
    dry_hold("y1 r1 mamba2_370m train", "y1", meta, build, 0, Y1_STEPS)


def dry_y2(meta) -> None:
    """y2: m1's decode step (gemma3_12b at full width, batch 4, cache 1,152,
    position 1,040) on the dry-run's decode cell: the f32 masters it
    reads (as the reference's cell), drawn on the card from a seed; the
    cache and the token random from the same generator."""
    cfg = api.get_config(Y2_ARCH)

    def build():
        gen = torch.Generator(device=DEV).manual_seed(0)
        model = api.build_model(cfg)
        params = model.init_params(gen)
        cache = api.tree_map(
            lambda t: torch.randn(t.shape, generator=gen, device=DEV).to(t.dtype),
            model.init_cache(Y2_BATCH, Y2_LEN, "meta"))
        token = torch.randint(0, cfg.vocab, (Y2_BATCH, 1), generator=gen,
                              device=DEV, dtype=torch.int32)
        return params, cache, token, Y2_POS
    dry_hold("y2 m1 gemma3_12b decode", "y2", meta, build, dryrun.POS_BYTES,
             Y2_STEPS)


def dry_y3(meta) -> None:
    """y3: ``run_cell`` on the single-pod mesh for ``Y3_CELLS`` (``meta``, a
    future of ``dry_meta("y3")``); their table through
    ``report.render``."""
    recs = {}
    for rec in meta.result():
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run y3: {rec}")
        recs[f"{rec['arch']}|{rec['shape']}|single"] = rec
        log(f"dry-run y3 {rec['arch']} {rec['shape']} single: counting run "
            f"{rec['compile_s']} s, {rec['flops']:.6g} FLOPs and "
            f"{rec['bytes_accessed']:.6g} B a device, collectives "
            f"{rec['collectives']['total']:.6g} B, bound "
            f"{rec['roofline']['step_s_lower_bound'] * 1e3:.4f} ms "
            f"({rec['roofline']['bottleneck']}), useful "
            f"{rec['useful_compute_ratio']:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dryrun_torch.json")
        with open(path, "w") as f:
            json.dump(recs, f)
        report.render(path, "single", fh=sys.stdout)
    sys.stdout.flush()
    log(f"dry-run y3: {len(Y3_CELLS)} cells, counting runs "
        f"{sum(r['compile_s'] for r in recs.values()):.1f} s in a worker "
        f"process; left to the CLI on a host (minutes a cell on meta): "
        + ", ".join(f"{a} {s}" for a, s in Y3_LEFT))


def phase_dryrun():
    """The dry-run tooling: y1-y3, the meta measurements in worker
    processes while the card runs y1's and y2's steps.  Launch counters
    read around exactly y1-y3: the path runs none of the kernels.
    Returns the launches."""
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"dry-run: {torch.cuda.memory_allocated()} B allocated at the start")
    ops.reset_launches()
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=3, mp_context=spawn) as pool:
        meta = {k: pool.submit(dry_meta, k) for k in ("y1", "y2", "y3")}
        dry_y1(meta["y1"])
        dry_y2(meta["y2"])
        dry_y3(meta["y3"])
    dry = dict(ops.LAUNCHES)
    log("launches on the dry-run path: " + json.dumps(dry))
    if any(dry.values()):
        raise AssertionError(f"dry-run path: launches {dry}; the dry-run runs "
                             f"none of the kernels")
    log(f"dry-run path (phase 14): {time.perf_counter() - t_start:.1f} s")
    return dry


def main() -> int:
    if sys.argv[1:] == [R1_DET_FLAG]:
        return r1_deterministic_worker()
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
        ("b", stream_b(), "dpsub", 4),
        ("c", stream_c, "auto", 4),
    ]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with ChunkCalls() as chunks:
        stream_res = {label: run_stream(label, graphs, algorithm, n_cpu)
                      for label, graphs, algorithm, n_cpu in streams}
    batched = dict(ops.LAUNCHES)
    log("launches on the batched path: " + json.dumps(batched))
    check_path("batched", batched, BATCHED_PATH, chunks.count)
    log(f"max_memory_allocated (batched path): "
        f"{torch.cuda.max_memory_allocated()} bytes")
    profile("stream a", lambda: batch.optimize_many(streams[0][1], "auto"),
            BATCHED_PATH)
    log(f"phase batched path done at {time.perf_counter() - t_start:.1f} s")

    parts = solo_parts()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with ChunkCalls() as chunks:
        solo_res = {label: run_solo(label, g, algorithm, opts, vs_cpu)
                    for label, g, algorithm, opts, vs_cpu in parts}
        run_solo_many(stream_c)
    solo = dict(ops.LAUNCHES)
    log("launches on the solo path: " + json.dumps(solo))
    check_path("solo", solo, SOLO_PATH, chunks.count)
    log(f"max_memory_allocated (solo path): "
        f"{torch.cuda.max_memory_allocated()} bytes")
    torch.cuda.empty_cache()
    d1 = parts[0]
    profile("solo d1", lambda: engine.optimize(d1[1], d1[2]), SOLO_PATH)
    log(f"phase solo path done at {time.perf_counter() - t_start:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    typed, t20 = phase_typed()
    log(f"max_memory_allocated (typed path): "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log(f"phase typed path done at {time.perf_counter() - t_start:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    heur, heur_out = phase_heuristics()
    log(f"max_memory_allocated (heuristics path): "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log(f"phase heuristics path done at {time.perf_counter() - t_start:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    svc, svc_out = phase_service(streams[0][1], stream_res["a"],
                                 solo_res["d1"], heur_out)
    log(f"phase service path done at {time.perf_counter() - t_start:.1f} s")

    dmn = phase_daemon(svc_out)
    log(f"phase daemon path done at {time.perf_counter() - t_start:.1f} s")

    shd = phase_sharded(stream_res, solo_res, t20, heur_out, svc_out)
    log(f"phase sharded path done at {time.perf_counter() - t_start:.1f} s")

    exe = phase_execute()
    log(f"phase execute path done at {time.perf_counter() - t_start:.1f} s")

    srv = phase_serve()
    log(f"phase serve path done at {time.perf_counter() - t_start:.1f} s")

    trn = phase_train()
    log(f"phase train path done at {time.perf_counter() - t_start:.1f} s")

    dry = phase_dryrun()
    log(f"phase dry-run path done at {time.perf_counter() - t_start:.1f} s")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")

    out = [{"name": k, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ccp_eval.cu",
            "replaces": KERNELS[k][2],
            "launches": (batched[k] + solo[k] + typed[k] + heur[k] + svc[k]
                         + dmn[k] + shd[k] + exe[k] + srv[k] + trn[k]
                         + dry[k]),
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
