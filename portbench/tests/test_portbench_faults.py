"""A run with its timed path broken underneath comes out not correct:
once for each fault these cells can have.  The runs skip the look for a
card and drive the rest of a run on the CPU, at small sizes.

The faults: an answer altered where it is produced (the batched engine's
result, the solo engine's result, the heuristic's final costing), and, for
the heuristic, whose rounds batch their subproblems, half of each batch
left out (its answers are the other half's).  A step returning its state
unchanged (training) and the exchange between chips (one chip) are not
faults these cells can have.
"""
import pytest

import tinycell


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tinycell.make(tmp_path_factory.mktemp("bench"))


def _scaled(real):
    def wrapper(*a, **kw):
        r = real(*a, **kw)
        r.cost = r.cost * 1.05
        return r
    return wrapper


def test_a_sound_run_is_correct(base):
    rc, res = tinycell.run(base, "musicbrainz.tiny", 11)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert res["checks"]["cost_gap"]["value"] < 1e-5


def test_an_altered_batched_answer_is_caught(base, monkeypatch):
    from repro_torch.core import batch
    monkeypatch.setattr(batch, "_memo_result", _scaled(batch._memo_result))
    rc, res = tinycell.run(base, "musicbrainz.tiny", 12)
    assert rc == 0 and not res["correct"] and res["failed"] > 0
    assert res["checks"]["cost_gap"]["value"] > 0.04


def test_an_altered_solo_answer_is_caught(base, monkeypatch):
    from repro_torch.core import engine
    from repro_torch.core.service import StreamOptimizer
    monkeypatch.setattr(engine, "optimize", _scaled(engine.optimize))
    # every query goes solo, as the 18-20-relation cell's do
    monkeypatch.setattr(StreamOptimizer, "admit",
                        lambda self, graphs, idxs: ([], list(idxs)))
    rc, res = tinycell.run(base, "musicbrainz.tiny", 13)
    assert rc == 0 and not res["correct"]
    assert res["checks"]["plan_cost_gap"]["value"] > 0.04


def test_an_altered_heuristic_answer_is_caught(base, monkeypatch):
    from repro_torch.core.plan import cost_plan
    from repro_torch.heuristics import uniondp

    def skewed(p, g):
        q = cost_plan(p, g)
        q.cost *= 1.05
        return q

    monkeypatch.setattr(uniondp, "cost_plan", skewed)
    rc, res = tinycell.run(base, "snowflake.tiny_heuristic", 14)
    assert rc == 0 and not res["correct"]
    assert res["checks"]["plan_cost_gap"]["value"] > 0.04


def test_half_the_heuristics_batch_left_out_is_caught(base, monkeypatch):
    from repro_torch.core import engine
    real = engine.optimize_many

    def half(graphs, *a, **kw):
        keep = (len(graphs) + 1) // 2
        rs = real(graphs[:keep], *a, **kw)
        return [rs[i % keep] for i in range(len(graphs))]

    monkeypatch.setattr(engine, "optimize_many", half)
    rc, res = tinycell.run(base, "snowflake.tiny_heuristic", 15)
    assert rc == 0 and not res["correct"]
    nums = {k: v["value"] for k, v in res["checks"].items()}
    assert nums["invalid_plans"] + nums["unanswered"] > 0
