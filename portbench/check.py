"""Whether what the timed path produced is correct: the program's answers
held against the plain reference, each number beside its limit.

* ``unanswered``: requests sent that never came back, or came back with an
  error or a refusal (limit 0).
* ``invalid_plans``: checked answers whose plan is not a join tree joining,
  at every node, two connected relation sets with an edge between them,
  over every relation of the query once (limit 0).
* ``plan_cost_gap``: the largest relative gap between an answer's reported
  cost and the reference's cost of the plan it carries.
* ``cost_gap`` (exact answers): the largest relative gap between the
  reported cost and the reference's optimum.

The answers checked are every request answered, or a sample of
``sample`` of them drawn from the seed.
"""
from __future__ import annotations

import random

from .reference import exact
from .reference.plans import invalid_reason, plan_cost
from .stream import derive


def pick(requests, k: int, seed: int) -> list:
    answered = sorted((r for r in requests if r.ok),
                      key=lambda r: (r.client, r.j))
    if k is None or len(answered) <= k:
        return answered
    return random.Random(derive(seed, "sample")).sample(answered, k)


def judge(requests, *, guarantee: str, sample, seed: int,
          limits: dict) -> dict:
    """The numbers compared over the window's requests, the answers
    checked, and ``failed``: the requests unanswered, plus the checked ones
    with an answer over a limit."""
    checked = pick(requests, sample, seed)
    out = {"unanswered": sum(1 for r in requests if not r.ok),
           "invalid_plans": 0, "plan_cost_gap": 0.0}
    if guarantee == "exact":
        out["cost_gap"] = 0.0
    elif guarantee != "heuristic":
        raise ValueError(f"unknown guarantee {guarantee!r}")
    failed = out["unanswered"]
    for r in checked:
        bad = False
        for w, cost, plan in zip(r.wires, r.costs, r.plans):
            if invalid_reason(plan, w) is not None:
                out["invalid_plans"] += 1
                bad = True
                continue
            own = plan_cost(plan, w)
            gap = abs(cost - own) / own
            out["plan_cost_gap"] = max(out["plan_cost_gap"], gap)
            bad |= gap > limits.get("plan_cost_gap", float("inf"))
            if guarantee == "exact":
                opt, _ = exact.solve(w)
                gap = abs(cost - opt) / opt
                out["cost_gap"] = max(out["cost_gap"], gap)
                bad |= gap > limits.get("cost_gap", float("inf"))
        failed += bad
    out["checked"] = sum(len(r.wires) for r in checked)
    out["failed"] = failed
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers that have
    a limit; a number over its limit, or missing, fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        table[name] = {"value": v, "limit": limit}
        if v is None or not v <= limit:
            ok = False
    return ok, table
