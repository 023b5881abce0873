"""Learned optimizer policies from execution telemetry.

The port's own copy of ``repro.core.policy``, on the port's
``telemetry.FlightTelemetry`` and cost model.  The engine has static
thresholds: the lane-space dispatch (``auto`` -> MPDP:Tree / MPDP-general
by topology), the ``CHUNK`` lane-chunk size, the ``PEND_WINDOW`` drain
window, UnionDP's ``reopt_rounds`` and the exact-vs-heuristic relation
cutoff.  :class:`PolicyTable` closes the loop: it consumes flight
telemetry records and EMA-learns, per (NMAX bucket, admitted lane space),
which concrete space is fastest on this hardware, how small the chunk can
shrink and how deep the drain window needs to be; through
:meth:`record_execution` it also keeps per-relation cardinality
corrections for ``cost.np_corrected_graph`` and
``PlanCache.invalidate_drift``.

The reference's contract holds:

* **Off by default.**  No entry point builds a ``PolicyTable``; with
  ``OptimizerConfig.policy is None`` every dispatcher takes the static
  path.
* **Plans never change.**  All three lane spaces enumerate the same CCP
  minima, so overriding the space, chunk or drain window moves walls and
  lane counts, never costs or plans.  The policy picks only among spaces
  valid for the query's topology, and only under ``auto``/``mpdp``; an
  explicit ``algorithm`` is left alone.
* **Deterministic.**  Explore-then-exploit with a fixed candidate order
  and pure-EMA state: the table after a fixed telemetry sequence is a pure
  function of that sequence (no RNG, no clock).  :meth:`freeze` stops all
  updates.  The walls it learns from are the card's, so a table fed on
  the card learns other decisions than one fed on the CPU; the results
  stay the same.
* **Checkpoint-safe.**  :meth:`save`/:meth:`load` use the reference's
  pure-literal ``repr``/``ast.literal_eval`` format and atomic
  ``os.replace``, so a table file written by either package loads in the
  other; corrupt, truncated, tampered or version-drifted files load as a
  cold table with ``stale_load`` set and never execute code.
"""
from __future__ import annotations

import ast
import math
import os
from typing import Optional

POLICY_FILE_VERSION = 1

# EMA step sizes: flight walls are noisy (scheduler jitter), so space/chunk
# learning moves fast; cardinality corrections steer the cost model and the
# plan cache, so they move slower and each observation's step is clamped.
EMA_ALPHA = 0.3       # flight-profile EMAs (wall, lanes, chunks)
SEL_ALPHA = 0.25      # per-relation log2-row corrections
MAX_STEP_L2 = 1.0     # one observation moves a row estimate <= 2x

CHUNK_MIN = 1 << 12   # learned chunk never shrinks below 4096 lanes
CHUNK_MAX = 1 << 18
PEND_MIN = 2          # learned drain window keeps >= 2 chunks in flight
REOPT_MAX = 8
EXPLORE_FLIGHTS = 2   # flights per candidate space before exploiting

# Candidate lane spaces per admitted (auto-dispatch) space, in explore
# order.  The first candidate is the static default, so a cold table's
# first decision reproduces the static dispatch exactly.  ``mpdp_tree``
# is only valid for tree-shaped queries, so cyclic buckets (admitted as
# ``mpdp_general``) never offer it.
_SPACE_CANDIDATES = {
    "mpdp_tree": ("mpdp_tree", "dpsub", "mpdp_general"),
    "mpdp_general": ("mpdp_general", "dpsub"),
    "dpsub": ("dpsub",),
}

# Exception set mirroring PlanCache.load: anything a hostile literal can
# raise during parse/validation lands here and degrades to a cold table.
_LOAD_ERRORS = (ValueError, SyntaxError, KeyError, TypeError,
                MemoryError, RecursionError, IndexError, OverflowError)


def _ema(cur, obs, alpha):
    return float(obs) if cur is None else float(cur) + alpha * (float(obs) - float(cur))


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


class PolicyDecision:
    """One dispatch decision.  ``None`` fields mean 'keep the caller's
    static default' — a cold or frozen-without-data table emits all-None
    decisions, which is how policy-on converges to policy-off behavior."""

    __slots__ = ("space", "chunk", "pend_window")

    def __init__(self, space: Optional[str] = None, chunk: Optional[int] = None,
                 pend_window: Optional[int] = None):
        self.space = space
        self.chunk = chunk
        self.pend_window = pend_window

    def __repr__(self):
        return (f"PolicyDecision(space={self.space!r}, chunk={self.chunk}, "
                f"pend_window={self.pend_window})")


class PolicyStats:
    __slots__ = ("decisions", "observations", "space_overrides", "row_updates")

    def __init__(self):
        self.decisions = 0
        self.observations = 0
        self.space_overrides = 0
        self.row_updates = 0

    def as_dict(self) -> dict:
        return {"decisions": self.decisions, "observations": self.observations,
                "space_overrides": self.space_overrides,
                "row_updates": self.row_updates}


class PolicyTable:
    """EMA-learned dispatch policies keyed by (NMAX bucket, admitted space).

    Entries are plain dicts of literals so the whole table round-trips
    through ``repr``/``ast.literal_eval``:

        (nmax, space) -> {
            "arms":   {candidate_space: [wall_per_query_ema, trials]},
            "lanes":  evaluated-lanes-per-flight EMA | None,
            "chunks": chunk-dispatches-per-flight EMA | None,
            "wallq":  wall-per-query EMA across all arms | None,
        }

    plus a per-relation-name row table ``name -> [log2_rows_ema, count]``
    and a scalar UnionDP accepted-reopt-rounds EMA.
    """

    def __init__(self, *, alpha: float = EMA_ALPHA, sel_alpha: float = SEL_ALPHA,
                 explore: int = EXPLORE_FLIGHTS, learn_space: bool = True,
                 learn_chunk: bool = True, learn_pend: bool = True):
        self.alpha = float(alpha)
        self.sel_alpha = float(sel_alpha)
        self.explore = int(explore)
        self.learn_space = bool(learn_space)
        self.learn_chunk = bool(learn_chunk)
        self.learn_pend = bool(learn_pend)
        self._entries: dict = {}        # (nmax, space) -> entry dict
        self._rows: dict = {}           # relation name -> [ema_l2, count]
        self._reopt: Optional[list] = None  # [accepted_rounds_ema, count]
        self.frozen = False
        self.stale_load = False
        self.stats = PolicyStats()

    # ------------------------------------------------------------ basics --

    def __len__(self) -> int:
        return len(self._entries)

    def freeze(self) -> None:
        """Stop all learning: decisions become a pure function of the
        current table, so warmed repeats replay identical dispatches."""
        self.frozen = True

    def thaw(self) -> None:
        self.frozen = False

    def _entry(self, nmax: int, space: str) -> dict:
        key = (int(nmax), str(space))
        e = self._entries.get(key)
        if e is None:
            e = {"arms": {}, "lanes": None, "chunks": None, "wallq": None}
            self._entries[key] = e
        return e

    # --------------------------------------------------------- decisions --

    def candidates(self, space: str):
        return _SPACE_CANDIDATES.get(str(space), (str(space),))

    def choose(self, nmax: int, space: str, *, default_chunk: int,
               default_pend: Optional[int] = None) -> PolicyDecision:
        """Dispatch decision for a flight admitted as (nmax, space).

        Space selection is explore-then-exploit over ``candidates(space)``
        in fixed order; the first candidate is the static default, so a
        cold table replays static dispatch while it gathers telemetry.
        Chunk/window overrides only ever *shrink* the static defaults, and
        only once the bucket has an observed lane/chunk profile.
        """
        self.stats.decisions += 1
        key = (int(nmax), str(space))
        e = self._entries.get(key)
        cands = self.candidates(space)

        chosen = str(space)
        if self.learn_space and len(cands) > 1:
            arms = e["arms"] if e else {}
            unexplored = None
            if not self.frozen:
                for c in cands:
                    if arms.get(c, (None, 0))[1] < self.explore:
                        unexplored = c
                        break
            if unexplored is not None:
                chosen = unexplored
            else:
                tried = [(arms[c][0] , i, c) for i, c in enumerate(cands)
                         if c in arms and arms[c][0] is not None]
                if tried:
                    chosen = min(tried)[2]
        if chosen != str(space):
            self.stats.space_overrides += 1

        chunk = None
        if self.learn_chunk and e and e["lanes"] is not None:
            # A chunk that covers the whole flight's evaluated lanes also
            # covers its largest level, so shrinking to the lane EMA's
            # pow2 ceiling never splits a level that fit one chunk before
            # — it only stops dispatching mostly-empty lane slots.
            want = _pow2_ceil(max(int(math.ceil(e["lanes"])), CHUNK_MIN))
            want = max(CHUNK_MIN, min(CHUNK_MAX, want))
            if want < int(default_chunk):
                chunk = want

        pend = None
        if self.learn_pend and default_pend and e and e["chunks"] is not None:
            want = max(PEND_MIN, int(math.ceil(e["chunks"])))
            if want < int(default_pend):
                pend = want

        return PolicyDecision(space=chosen, chunk=chunk, pend_window=pend)

    def observe(self, nmax: int, space: str, chosen_space: str, tele) -> None:
        """Fold one finished flight's telemetry back into the table.

        ``space`` is the admitted (bucketing) space, ``chosen_space`` the
        space actually executed, ``tele`` a ``FlightTelemetry``.
        """
        if self.frozen:
            return
        self.stats.observations += 1
        e = self._entry(nmax, space)
        wallq = float(tele.wall_s) / max(int(tele.queries), 1)
        arm = e["arms"].get(str(chosen_space))
        if arm is None:
            arm = [None, 0]
            e["arms"][str(chosen_space)] = arm
        arm[0] = _ema(arm[0], wallq, self.alpha)
        arm[1] = int(arm[1]) + 1
        e["wallq"] = _ema(e["wallq"], wallq, self.alpha)
        # lane/chunk profiles describe the *admitted* bucket shape, which
        # is space-dependent — only fold in flights run on the admitted
        # space so an explore detour can't skew the chunk rule.
        if str(chosen_space) == str(space):
            e["lanes"] = _ema(e["lanes"], int(tele.evaluated_lanes), self.alpha)
            e["chunks"] = _ema(e["chunks"], int(tele.chunks), self.alpha)

    # ------------------------------------------------- exact-limit / reopt --

    def exact_limit(self, default_n: int, budget_s: float) -> int:
        """Largest relation count the exact tier can afford per query.

        Walks observed buckets by NMAX: the limit rises to the largest
        bucket whose wall-per-query EMA fits ``budget_s`` and is capped
        below the smallest observed bucket that blows it.  With no
        telemetry the static ``default_n`` stands.
        """
        obs = sorted((k[0], e["wallq"]) for k, e in self._entries.items()
                     if e["wallq"] is not None)
        limit = int(default_n)
        for nmax, wallq in obs:
            if wallq <= float(budget_s):
                limit = max(limit, int(nmax))
            else:
                limit = min(limit, int(nmax) - 1)
                break
        return limit

    def observe_reopt(self, accepted_rounds: int) -> None:
        """Record how many UnionDP re-optimization passes actually
        improved the plan (``len(info["round_costs"]) - 1``)."""
        if self.frozen:
            return
        if self._reopt is None:
            self._reopt = [None, 0]
        self._reopt[0] = _ema(self._reopt[0], int(accepted_rounds), self.alpha)
        self._reopt[1] = int(self._reopt[1]) + 1

    def reopt_rounds_for(self, default_rounds: int) -> int:
        """Learned UnionDP ``reopt_rounds``: one past the EMA of accepted
        passes (so the loop still probes for a new improvement), clamped
        to [1, REOPT_MAX].  Cold table -> static default."""
        if self._reopt is None or self._reopt[0] is None:
            return int(default_rounds)
        return max(1, min(REOPT_MAX, int(math.ceil(self._reopt[0])) + 1))

    # ------------------------------------------------- cardinality feedback --

    def record_execution(self, g, observed_rows: dict, *, log2: bool = False,
                         cache=None) -> int:
        """Fold observed per-relation cardinalities into the row table.

        ``observed_rows`` maps relation name -> observed rows (or log2
        rows with ``log2=True``).  Each observation moves the stored
        estimate by at most ``sel_alpha * delta`` clamped to
        ``MAX_STEP_L2`` in log2 space — a single wild row count can never
        swing an estimate past 2x.  Estimates are seeded from ``g``'s own
        catalog stats, so a correction stream that matches the catalog is
        a no-op.  When ``cache`` is given, drifted entries are dropped via
        ``PlanCache.invalidate_drift`` and the count of dropped plans is
        returned.
        """
        if self.frozen:
            return 0
        name_to_l2 = {name: float(g.log2_card[v]) for v, name in enumerate(g.names)}
        for name, rows in observed_rows.items():
            name = str(name)
            if name not in name_to_l2:
                continue
            if log2:
                obs_l2 = float(rows)
            else:
                obs_l2 = math.log2(max(float(rows), 1.0))
            obs_l2 = max(obs_l2, 0.0)
            ent = self._rows.get(name)
            base = ent[0] if ent is not None else name_to_l2[name]
            step = self.sel_alpha * (obs_l2 - base)
            step = max(-MAX_STEP_L2, min(MAX_STEP_L2, step))
            count = int(ent[1]) + 1 if ent is not None else 1
            self._rows[name] = [float(base + step), count]
            self.stats.row_updates += 1
        if cache is not None and self._rows:
            return cache.invalidate_drift(self.drift_rows(), log2=True)
        return 0

    def drift_rows(self) -> dict:
        """Learned relation-name -> log2-rows map, for
        ``cost.np_corrected_graph`` and ``PlanCache.invalidate_drift``."""
        return {name: ent[0] for name, ent in self._rows.items()}

    def corrected(self, g):
        """``g`` with learned cardinality corrections applied (or ``g``
        itself when nothing learned touches it)."""
        from . import cost as cm
        return cm.np_corrected_graph(g, self.drift_rows())

    # --------------------------------------------------------- persistence --

    def save(self, path: str) -> None:
        """Atomic pure-literal checkpoint (same discipline as PlanCache):
        write ``repr`` of a dict of literals to a pid-suffixed temp file,
        then ``os.replace`` so concurrent readers never see a torn file."""
        entries = []
        for key in sorted(self._entries):
            e = self._entries[key]
            arms = [(s, e["arms"][s][0], int(e["arms"][s][1]))
                    for s in sorted(e["arms"])]
            entries.append((key, {"arms": arms, "lanes": e["lanes"],
                                  "chunks": e["chunks"], "wallq": e["wallq"]}))
        blob = {
            "header": {
                "version": POLICY_FILE_VERSION,
                "alpha": self.alpha,
                "sel_alpha": self.sel_alpha,
                "explore": self.explore,
            },
            "entries": entries,
            "rows": [(name, float(self._rows[name][0]), int(self._rows[name][1]))
                     for name in sorted(self._rows)],
            "reopt": (None if self._reopt is None
                      else (self._reopt[0], int(self._reopt[1]))),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(repr(blob))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, **kwargs) -> "PolicyTable":
        """Load a checkpoint; any corruption degrades to a cold table with
        ``stale_load`` set.  Missing files raise (caller's choice to cold-
        start), mirroring ``PlanCache.load``."""
        with open(path) as f:
            text = f.read()
        table = cls(**kwargs)
        try:
            blob = ast.literal_eval(text)
            header = blob["header"]
            if (int(header["version"]) != POLICY_FILE_VERSION
                    or float(header["alpha"]) != table.alpha
                    or float(header["sel_alpha"]) != table.sel_alpha
                    or int(header["explore"]) != table.explore):
                raise ValueError("policy header drift")
            entries = {}
            for key, e in blob["entries"]:
                nmax, space = key
                arms = {}
                for s, wall, trials in e["arms"]:
                    arms[str(s)] = [None if wall is None else float(wall),
                                    int(trials)]
                entries[(int(nmax), str(space))] = {
                    "arms": arms,
                    "lanes": None if e["lanes"] is None else float(e["lanes"]),
                    "chunks": None if e["chunks"] is None else float(e["chunks"]),
                    "wallq": None if e["wallq"] is None else float(e["wallq"]),
                }
            rows = {}
            for name, ema, count in blob["rows"]:
                rows[str(name)] = [float(ema), int(count)]
            reopt = blob["reopt"]
            if reopt is not None:
                reopt = [None if reopt[0] is None else float(reopt[0]),
                         int(reopt[1])]
        except _LOAD_ERRORS:
            table.stale_load = True
            return table
        table._entries = entries
        table._rows = rows
        table._reopt = reopt
        return table

    # -------------------------------------------------------------- stats --

    def summary(self) -> dict:
        """Literal-only snapshot for daemon STATS / debugging."""
        out = {"entries": len(self._entries), "rows": len(self._rows),
               "frozen": self.frozen, "stale_load": self.stale_load}
        out.update(self.stats.as_dict())
        return out
