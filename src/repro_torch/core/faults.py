"""Deterministic, process-global fault-injection plane (chaos testing).

The port's own copy of ``repro.core.faults``: the same sites, actions,
spec strings, seeded plans and ``REPRO_FAULTS`` variable, so one fault
schedule means the same thing to either package.  The resilience layer
(deadlines, retries, daemon supervision, degraded plans) is only
trustworthy if its failure paths are exercised, and the failures it
guards against (a failed launch, a crashed worker thread, a torn
checkpoint write, a mid-frame socket stall) almost never happen on their
own.  This module makes them happen on demand, deterministically:

  * a ``FaultPlan`` is a set of fire-on-Nth-call ``FaultRule``\\ s keyed by
    *site*, a named seam in the production code: ``"chunk"`` is one device
    dispatch of the batched engine (each ``bconnectivity_span`` launch of
    the filter and each evaluate chunk; the reference fires once per
    ``chunk`` filter lanes instead, so ``chunk@N`` lands on another
    dispatch in each package), ``"cache_write"`` the ``PlanCache.save``
    checkpoint, ``"worker"`` the daemon's optimizer worker and
    ``"socket_send"`` the wire protocol's frame send;
  * production seams call ``faults.fire(site)`` / ``faults.check(site)``;
    with no plan installed the call is a single ``is None`` test, with no
    change of behaviour;
  * ``install(plan)`` arms the plan process-wide; call counters and the
    fired-rule log are kept under a lock, so multi-threaded seams (the
    daemon) stay deterministic per site;
  * ``FaultPlan.seeded(seed, ...)`` derives the Nth-call indices from a
    ``random.Random(seed)``, and plans round-trip through a compact spec
    string (``"site@nth:action[:delay]"``), so one ``REPRO_FAULTS``
    variable arms a daemon subprocess with the same schedule every run.

``now()`` is the cooperative-deadline clock of every engine-level deadline
check.  It is a module attribute on purpose: tests replace it with a fake
counter to make a deadline expire at an exact DP level, so the engines
call it through the module (``faults.now()``) and nowhere else read a
clock for a deadline.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

SITES = ("chunk", "cache_write", "worker", "socket_send")
ACTIONS = ("raise", "sleep", "corrupt", "stall")


class InjectedFault(RuntimeError):
    """An injected failure fired at a fault site (never raised unless a
    ``FaultPlan`` is installed)."""


def now() -> float:
    """The deadline clock (monotonic seconds).  Deadline checks must call
    this through the module (``faults.now()``) so tests can substitute a
    deterministic fake clock."""
    return time.perf_counter()


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """Fire ``action`` on the ``nth`` call (1-based) to ``site``."""

    site: str
    nth: int
    action: str = "raise"
    delay_s: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {SITES})")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {ACTIONS})")
        if self.nth < 1:
            raise ValueError(f"nth must be >= 1, got {self.nth}")

    def spec(self) -> str:
        base = f"{self.site}@{self.nth}:{self.action}"
        if self.delay_s:
            base += f":{self.delay_s}"
        return base

    @staticmethod
    def from_spec(s: str) -> "FaultRule":
        head, _, rest = s.strip().partition("@")
        parts = rest.split(":")
        if not head or len(parts) < 2:
            raise ValueError(f"bad fault rule spec {s!r} "
                             "(want 'site@nth:action[:delay]')")
        delay = float(parts[2]) if len(parts) > 2 else 0.0
        return FaultRule(site=head, nth=int(parts[0]), action=parts[1],
                         delay_s=delay)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of fault rules, installable process-wide."""

    rules: tuple = ()
    seed: int = 0

    def spec(self) -> str:
        """Compact wire form: semicolon-joined rule specs (env-var safe)."""
        return ";".join(r.spec() for r in self.rules)

    @staticmethod
    def from_spec(s: str) -> "FaultPlan":
        rules = tuple(FaultRule.from_spec(part)
                      for part in s.split(";") if part.strip())
        return FaultPlan(rules=rules)

    @staticmethod
    def seeded(seed: int, *, chunk_failures: int = 0, slow_chunks: int = 0,
               cache_corruptions: int = 0, worker_crashes: int = 0,
               socket_stalls: int = 0, window: int = 50,
               delay_s: float = 0.05) -> "FaultPlan":
        """Derive a deterministic plan: each requested fault lands on an
        Nth-call index drawn from ``random.Random(seed)`` within
        ``[1, window]`` — same seed, same schedule, every run."""
        import random
        rng = random.Random(seed)

        def draws(count):
            return sorted(rng.sample(range(1, window + 1),
                                     min(count, window)))

        rules = []
        rules += [FaultRule("chunk", n) for n in draws(chunk_failures)]
        rules += [FaultRule("chunk", n, "sleep", delay_s)
                  for n in draws(slow_chunks)]
        rules += [FaultRule("cache_write", n, "corrupt")
                  for n in draws(cache_corruptions)]
        rules += [FaultRule("worker", n) for n in draws(worker_crashes)]
        rules += [FaultRule("socket_send", n, "stall", delay_s)
                  for n in draws(socket_stalls)]
        return FaultPlan(rules=tuple(rules), seed=seed)


# Process-global installed plan.  ``_PLAN is None`` is THE fast path: every
# production seam tests it first, so an uninstrumented run costs one
# attribute load + identity check per seam call.
_PLAN: FaultPlan | None = None
_LOCK = threading.Lock()
_COUNTS: dict[str, int] = {}
_FIRED: list[str] = []


def install(plan: FaultPlan) -> None:
    """Arm ``plan`` process-wide, resetting call counters and the fired
    log.  Intended for tests / chaos benchmarks only."""
    global _PLAN
    with _LOCK:
        _COUNTS.clear()
        _FIRED.clear()
        _PLAN = plan


def uninstall() -> None:
    """Disarm fault injection (the default state)."""
    global _PLAN
    with _LOCK:
        _PLAN = None
        _COUNTS.clear()
        _FIRED.clear()


def active() -> bool:
    return _PLAN is not None


def install_from_env(env: str = "REPRO_FAULTS") -> bool:
    """Install a plan from ``$REPRO_FAULTS`` (a ``FaultPlan.spec`` string);
    returns whether one was installed.  The daemon main() calls this so a
    chaos benchmark can arm a subprocess without code changes."""
    spec = os.environ.get(env, "").strip()
    if not spec:
        return False
    install(FaultPlan.from_spec(spec))
    return True


def check(site: str) -> FaultRule | None:
    """Count a call to ``site``; return the rule scheduled for exactly this
    call, if any.  Callers that need a non-raise action (corrupt, stall)
    use the returned rule; plain failure seams use ``fire`` instead."""
    plan = _PLAN
    if plan is None:
        return None
    with _LOCK:
        if _PLAN is not plan:                      # racing uninstall
            return None
        n = _COUNTS.get(site, 0) + 1
        _COUNTS[site] = n
        for rule in plan.rules:
            if rule.site == site and rule.nth == n:
                _FIRED.append(rule.spec())
                return rule
    return None


def fire(site: str) -> FaultRule | None:
    """``check`` + apply the simple actions in place: ``raise`` raises
    ``InjectedFault``, ``sleep`` delays the caller.  Other actions are
    returned for the seam to apply itself."""
    rule = check(site)
    if rule is None:
        return None
    if rule.action == "raise":
        raise InjectedFault(f"injected fault at {rule.spec()}")
    if rule.action == "sleep":
        time.sleep(rule.delay_s)
    return rule


def fired() -> list[str]:
    """Specs of the rules that have fired since ``install`` (test support)."""
    with _LOCK:
        return list(_FIRED)
