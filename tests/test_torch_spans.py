"""The port's span recorder (``repro_torch.core.telemetry``) on the CPU.

* off (the default), nothing is recorded, and the stage timings are kept;
* a daemon request's spans (``daemon.queue`` to ``engine.fetch``) share
  one request id, and each has the parent the call tree gives it;
* per flight, solo run, sharded flight and lattice flight, the
  ``engine.filter`` / ``engine.evaluate`` / ``engine.phase_a`` spans sum
  to the result's ``timings["filter"]``, ``["evaluate"]`` and
  ``["blocks"]`` within 1 us a span;
* UnionDP's ``uniondp.partition`` and ``uniondp.subsolve`` spans lie
  inside their ``uniondp.solve``;
* a full buffer drops its oldest spans and counts them.

Every test leaves the recorder off and empty.
"""
import collections
import threading

import pytest

from repro_torch.core import batch, engine, shard, telemetry
from repro_torch.core.config import OptimizerConfig
from repro_torch.core.service import StreamOptimizer
from repro_torch.daemon import DaemonClient, OptimizerDaemon
from repro_torch.heuristics import uniondp
from repro_torch.workloads import generators as gen
from tests.test_torch_batch import one_torch_thread  # noqa: F401

WAIT = 10.0
# a cyclic query (phase A), a star and a chain: two flights
GRAPHS = [gen.cycle(7, 3), gen.star(6, 2), gen.chain(5, 1)]
STAGE_KEYS = {"engine.filter": "filter", "engine.evaluate": "evaluate",
              "engine.phase_a": "blocks"}


@pytest.fixture(autouse=True)
def recorder_off():
    telemetry.disable()
    telemetry.clear()
    yield
    telemetry.disable()
    telemetry.clear()


def by_id(spans):
    return {s.id: s for s in spans}


def assert_stages_match(spans, parent, timings):
    """The stage spans under ``parent`` (at any depth below it, through
    spans that are not themselves stages) sum to ``timings``."""
    ids = by_id(spans)

    def under(s):
        while s.parent is not None:
            s = ids[s.parent]
            if s.id == parent.id:
                return True
        return False

    for name, key in STAGE_KEYS.items():
        got = [s for s in spans if s.name == name and under(s)]
        total = sum(s.t1 - s.t0 for s in got) * 1e-9
        assert abs(total - timings.get(key, 0.0)) <= 1e-6 * max(len(got), 1), \
            (name, total, timings.get(key))
        if key in timings:
            assert got, name


def test_off_records_nothing():
    res = batch.optimize_many(GRAPHS, device="cpu")
    solo = engine.optimize(gen.cycle(7, 1), device="cpu")
    uniondp.solve(gen.snowflake(24, 5), k=8, device="cpu")
    assert telemetry.spans() == [] and telemetry.dropped() == 0
    assert telemetry.new_request() == 0
    assert {"filter", "evaluate"} <= set(res[0].timings)
    assert set(solo.timings) == {"filter", "blocks", "evaluate"}


def test_daemon_request_spans_share_one_request(tmp_path):
    d = OptimizerDaemon(socket_path=str(tmp_path / "s.sock"), device="cpu",
                        checkpoint_every=10_000)
    d.start()
    try:
        with DaemonClient(socket_path=d.address, connect_timeout=WAIT) as c:
            telemetry.enable()
            c.optimize(GRAPHS, timeout=WAIT)
            telemetry.disable()
    finally:
        d.drain()
        assert d._stopped.wait(WAIT)
    spans = telemetry.spans()
    (queue,) = [s for s in spans if s.name == "daemon.queue"]
    assert {s.request for s in spans} == {queue.request}
    assert all(s.thread == queue.thread for s in spans)   # the worker's
    names = {s.name for s in spans}
    assert {"daemon.decode", "daemon.run", "daemon.encode", "service.stream",
            "service.flight", "service.finalize", "engine.filter",
            "engine.evaluate", "engine.phase_a", "engine.fetch"} <= names
    ids = by_id(spans)
    parent = {s.id: ids[s.parent].name if s.parent else None for s in spans}
    want = {"daemon.queue": {None}, "daemon.decode": {None},
            "daemon.run": {None}, "daemon.encode": {None},
            "service.stream": {"daemon.run"},
            "service.flight": {"service.stream"},
            "service.finalize": {"service.stream"},
            "engine.filter": {"service.flight"},
            "engine.evaluate": {"service.flight"},
            "engine.phase_a": {"service.flight"},
            "engine.chunk": {"engine.evaluate"},
            "engine.fetch": {"engine.filter", "engine.evaluate",
                             "engine.phase_a"}}
    for s in spans:
        assert parent[s.id] in want[s.name], (s.name, parent[s.id])
    first = {n: min(s.t0 for s in spans if s.name == n) for n in names}
    assert queue.t1 <= first["daemon.decode"] <= first["daemon.run"] \
        <= first["daemon.encode"]
    for s in spans:
        if s.parent:
            p = ids[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1


def test_queue_span_is_the_wait_behind_a_held_worker(tmp_path):
    gate = threading.Event()
    d = OptimizerDaemon(socket_path=str(tmp_path / "q.sock"), device="cpu",
                        worker_gate=gate, checkpoint_every=10_000)
    d.start()
    telemetry.enable()
    try:
        done = []

        def send():
            with DaemonClient(socket_path=d.address,
                              connect_timeout=WAIT) as c:
                done.append(c.optimize(GRAPHS[1:2], timeout=WAIT))

        t = threading.Thread(target=send)
        t.start()
        hold = 0.3
        threading.Event().wait(hold)
        gate.set()
        t.join(timeout=WAIT)
        assert not t.is_alive() and done
    finally:
        gate.set()
        d.drain()
        assert d._stopped.wait(WAIT)
    (queue,) = [s for s in telemetry.spans() if s.name == "daemon.queue"]
    assert (queue.t1 - queue.t0) * 1e-9 >= hold * 0.9


@pytest.mark.parametrize("pipeline", [False, True])
def test_stage_spans_sum_to_timings(pipeline):
    graphs = GRAPHS + [gen.musicbrainz_query(10, 7), gen.snowflake(17, 2)]
    telemetry.enable()
    results, report = StreamOptimizer(
        config=OptimizerConfig(pipeline=pipeline, max_flight=2),
        device="cpu").optimize_stream(graphs)
    telemetry.disable()
    spans = telemetry.spans()
    flights = sorted((s for s in spans if s.name == "service.flight"),
                     key=lambda s: s.t0)
    assert len(flights) == len(report.flights) >= 3
    for span, fl in zip(flights, report.flights):
        assert_stages_match(spans, span, results[fl.queries[0]].timings)
    (solo,) = [s for s in spans if s.name == "service.solo"]
    assert report.solo == 1
    assert_stages_match(spans, solo, results[-1].timings)


@pytest.mark.parametrize("space", ["mpdp_general", "mpdp_tree"])
def test_sharded_and_lattice_stage_spans_sum_to_timings(space):
    mesh = shard.batch_mesh(["cpu"] * 2)
    graphs = ([gen.musicbrainz_query(9, 4), gen.cycle(8, 2), gen.clique(6, 1)]
              if space == "mpdp_general"
              else [gen.star(7, 1), gen.chain(8, 3), gen.snowflake(9, 2)])
    telemetry.enable()
    with telemetry.span("test.sharded") as root:
        got = shard.ShardedBatchEngine(graphs, mesh, algorithm=space).run()
    with telemetry.span("test.lattice") as lroot:
        lat = engine.optimize(graphs[0], config=OptimizerConfig(
            algorithm=space, lattice=True, mesh=mesh), device="cpu")
    telemetry.disable()
    spans = telemetry.spans()
    assert_stages_match(spans, by_id(spans)[root.id], got[0].timings)
    assert_stages_match(spans, by_id(spans)[lroot.id], lat.timings)
    assert lat.algorithm.startswith("lattice_")


def test_uniondp_spans_lie_inside_their_solve():
    telemetry.enable()
    for g in (gen.snowflake(30, 5), gen.musicbrainz_query(24, 2)):
        uniondp.solve(g, k=8, device="cpu")
    telemetry.disable()
    spans = telemetry.spans()
    ids = by_id(spans)
    solves = [s for s in spans if s.name == "uniondp.solve"]
    assert len(solves) == 2 and all(s.parent is None for s in solves)
    assert len({s.request for s in solves}) == 2
    inner = [s for s in spans
             if s.name in ("uniondp.partition", "uniondp.subsolve")]
    assert {s.name for s in inner} == {"uniondp.partition",
                                       "uniondp.subsolve"}
    assert {"uniondp.merge", "uniondp.reopt"} <= {s.name for s in spans}
    for s in inner:
        (solve,) = [o for o in solves if o.request == s.request]
        assert solve.t0 <= s.t0 <= s.t1 <= solve.t1
        a = s
        while a.parent is not None:
            a = ids[a.parent]
        assert a.id == solve.id
    assert any(ids[s.parent].name == "uniondp.reopt"
               for s in spans if s.name == "uniondp.subsolve")


def test_full_buffer_counts_its_drops(monkeypatch):
    monkeypatch.setattr(telemetry, "_buf", collections.deque(maxlen=4))
    telemetry.enable()
    for i in range(10):
        with telemetry.span(f"s{i}"):
            pass
    telemetry.record("r", 1, 2, request=7)
    got = telemetry.spans()
    assert [s.name for s in got] == ["s7", "s8", "s9", "r"]
    assert telemetry.dropped() == 7
    assert got[-1].request == 7 and (got[-1].t0, got[-1].t1) == (1, 2)
    telemetry.clear()
    assert telemetry.spans() == [] and telemetry.dropped() == 0
