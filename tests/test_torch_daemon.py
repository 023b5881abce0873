"""The port's optimizer daemon on the CPU (``device="cpu"``), and the wire
across the packages.

* mirrors of ``tests/test_daemon.py``: framing, codecs, end-to-end results
  bit for bit the in-process ``optimize_many`` (cold, then warm hits),
  cross-tenant hits, configs over the wire, STATS, request errors, SHED
  backpressure, drain, atomic checkpoints under load, forced drains;
* mirrors of ``tests/test_faults.py::TestDaemonFaults``: a crashed worker
  answered retryably and re-spawned, a bounded request-deadline wait, a
  stalled socket, degraded results reported, connect failures; plus a
  ``chunk`` fault inside a request (a structured error, then the next
  request bit for bit) and the command line (``--devices 2`` refused
  before the socket opens; a daemon process with ``REPRO_FAULTS`` that
  survives its faults and drains on SIGTERM to a cache file), and the
  kernel library loaded once when many threads ask for it at once;
* across the packages, both daemons in this process on unix sockets: a
  reference client against the port's daemon and a port client against
  the reference's give replies with the same keys (``ok``, ``results``,
  ``wall_s``, ``flights``, ``lattice``, ``solo``, ``cache_hits``,
  ``degraded``; STATS' ``exec``, ``policy``, ``telemetry``, tenants),
  costs within a relative 1e-5 and plan shapes equal or a shown tie.

Every wait has its own timeout of at most 10 s; the graphs stay in the
nmax-8 bucket, and the reference's executables are compiled once in this
process before its daemon serves.
"""
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import batch as rbatch
from repro.core.policy import PolicyTable as RPolicyTable
from repro.daemon import DaemonClient as RClient, OptimizerDaemon as RDaemon
from repro.daemon import protocol as rproto
from repro.workloads import generators as rgen
from repro_torch.core import batch, engine, faults
from repro_torch.core.config import OptimizerConfig
from repro_torch.core.faults import FaultPlan, FaultRule
from repro_torch.core.plan import cost_plan, validate_plan
from repro_torch.core.plancache import PlanCache
from repro_torch.core.policy import PolicyTable
from repro_torch.daemon import (DaemonClient, DaemonError, DaemonShed,
                                FrameTimeout, OptimizerDaemon)
from repro_torch.daemon import protocol as proto
from repro_torch.daemon import server
from repro_torch.heuristics import goo
from repro_torch.workloads import generators as gen
from tests.test_torch_batch import REL, one_torch_thread, tjg_plan  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = [gen.chain(5, 1), gen.star(6, 2), gen.musicbrainz_query(8, 3)]
R_SMALL = [rgen.chain(5, 1), rgen.star(6, 2), rgen.musicbrainz_query(8, 3)]
WAIT = 10.0
CPU = dict(device="cpu")


def plan_shape(p):
    if p.is_leaf:
        return p.rel_set
    return (p.rel_set, plan_shape(p.left), plan_shape(p.right))


def fingerprint(results):
    return [(float(r.cost), plan_shape(r.plan)) for r in results]


def many(graphs, **kw):
    return batch.optimize_many(graphs, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.uninstall()
    yield
    faults.uninstall()


def start(tmp_path, name="d.sock", **kw):
    d = OptimizerDaemon(socket_path=str(tmp_path / name), device="cpu", **kw)
    d.start()
    return d


def stop(d):
    d.drain()
    assert d._stopped.wait(WAIT)


@pytest.fixture
def daemon(tmp_path):
    """A started port daemon on a per-test unix socket; drained after."""
    d = start(tmp_path, checkpoint_every=10_000)
    yield d
    stop(d)


def client(d, **kw):
    return DaemonClient(socket_path=d.address, connect_timeout=WAIT, **kw)


# ================================================================== framing

class TestFraming:
    def test_roundtrip(self):
        a, b = socket.socketpair()
        with a, b:
            proto.send_msg(a, {"op": "ping", "x": [1, 2.5, "s", None]})
            assert proto.recv_msg(b) == {"op": "ping",
                                         "x": [1, 2.5, "s", None]}

    def test_clean_eof_is_none(self):
        a, b = socket.socketpair()
        with b:
            a.close()
            assert proto.recv_msg(b) is None

    def test_mid_frame_eof_raises(self):
        a, b = socket.socketpair()
        with b:
            a.sendall(b"\x00\x00\x00\xff{1")
            a.close()
            with pytest.raises(proto.ProtocolError):
                proto.recv_msg(b)

    def test_oversize_frame_rejected(self):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(b"\xff\xff\xff\xff")
            with pytest.raises(proto.ProtocolError):
                proto.recv_msg(b)

    def test_multiple_frames_and_packages_interleave(self):
        """Frames of either package read in the other."""
        a, b = socket.socketpair()
        with a, b:
            for i in range(5):
                (proto if i % 2 else rproto).send_msg(a, {"i": i})
            got = [(rproto if i % 2 else proto).recv_msg(b)["i"]
                   for i in range(5)]
            assert got == list(range(5))


# =================================================================== codecs

class TestCodecs:
    def test_graph_roundtrip_bit_identical(self):
        for g in SMALL:
            wire = json.loads(json.dumps(proto.graph_to_wire(g)))
            g2 = proto.graph_from_wire(wire)
            np.testing.assert_array_equal(g.log2_card, g2.log2_card)
            np.testing.assert_array_equal(g.log2_sel, g2.log2_sel)
            assert list(g.edges) == list(g2.edges)
            assert tuple(g.names) == tuple(g2.names)

    def test_result_roundtrip(self):
        g = SMALL[0]
        r = engine.optimize(g, **CPU)
        wire = json.loads(json.dumps(proto.result_to_wire(r)))
        r2 = proto.result_from_wire(wire, g)
        assert float(r2.cost) == float(r.cost)
        assert plan_shape(r2.plan) == plan_shape(r.plan)
        assert r2.algorithm == r.algorithm
        assert (r2.counters.evaluated, r2.counters.ccp) == \
            (r.counters.evaluated, r.counters.ccp)

    def test_result_wire_matches_reference(self):
        """The same query's result wires: equal keys, plan shapes, counters
        and algorithm, costs within REL; each decodes in the other
        package."""
        from repro.core import engine as reng
        for g, rg in zip(SMALL, R_SMALL):
            ours = proto.result_to_wire(engine.optimize(g, **CPU))
            theirs = rproto.result_to_wire(reng.optimize(rg))
            assert set(ours) == set(theirs)
            for k in ("algorithm", "levels", "evaluated", "ccp", "plan"):
                assert ours[k] == theirs[k], k
            assert math.isclose(ours["cost"], theirs["cost"], rel_tol=REL)
            back = rproto.result_from_wire(json.loads(json.dumps(ours)), rg)
            assert plan_shape(back.plan) == plan_shape(
                proto.result_from_wire(theirs, g).plan)


# =============================================================== end to end

class TestDaemonEndToEnd:
    def test_bit_identical_and_warm_hits(self, daemon):
        with client(daemon, tenant="t1") as c:
            assert c.ping()
            cold = c.optimize(SMALL, timeout=WAIT)
            ref_cache = PlanCache()
            assert fingerprint(cold) == fingerprint(many(SMALL,
                                                         cache=ref_cache))
            warm = c.optimize(SMALL, timeout=WAIT)
            assert fingerprint(warm) == fingerprint(many(SMALL,
                                                         cache=ref_cache))
            assert c.last_meta["cache_hits"] == len(SMALL)

    def test_cross_tenant_plan_cache(self, daemon):
        with client(daemon, tenant="a") as ca:
            ca.optimize(SMALL, timeout=WAIT)
        with client(daemon, tenant="b") as cb:
            cb.optimize(SMALL, timeout=WAIT)
            assert cb.last_meta["cache_hits"] == len(SMALL)

    def test_config_over_the_wire(self, daemon):
        with client(daemon) as c:
            res = c.optimize([SMALL[0]], timeout=WAIT,
                             config=OptimizerConfig(algorithm="dpsub"))
            assert res[0].algorithm.startswith("batch_dpsub")

    def test_sharded_request_is_a_request_error(self, daemon):
        """A request pinning more devices than exist gets the mesh's error
        as a structured reply; one pinning 2 logical CPU shards is served,
        equal to the unsharded run."""
        from repro_torch.hostdev import ensure_host_devices, host_device_count
        ensure_host_devices(4)
        ndev = host_device_count()
        with client(daemon) as c:
            with pytest.raises(DaemonError, match=rf"only {ndev} cpu device"):
                c.optimize([SMALL[0]], timeout=WAIT,
                           config=OptimizerConfig(devices=ndev + 1))
            assert c.ping()
            res = c.optimize(SMALL, timeout=WAIT,
                             config=OptimizerConfig(devices=2))
            assert fingerprint(res) == fingerprint(many(SMALL))

    def test_stats_shape(self, daemon):
        with client(daemon, tenant="s") as c:
            c.optimize(SMALL[:1], timeout=WAIT)
            st = c.stats()
            assert st["requests"] >= 1 and st["queries"] >= 1
            assert st["tenants"]["s"]["requests"] == 1
            assert set(st["exec"]) == {"keys", "compiles", "retraces"}
            assert st["exec"]["retraces"] == 0
            assert {"entries", "hits", "misses"} <= set(st["plancache"])
            for k in ("p50", "p95", "p99"):
                assert st["request_wall_s"][k] >= 0.0

    def test_unknown_op_keeps_connection_usable(self, daemon):
        with client(daemon) as c:
            with pytest.raises(Exception, match="unknown op"):
                c._call({"op": "bogus"}, timeout=WAIT)
            assert c.ping()

    def test_malformed_graph_is_request_error(self, daemon):
        with client(daemon) as c:
            proto.send_msg(c._sock, {"op": "optimize", "graphs": [{"n": 3}]})
            c._sock.settimeout(WAIT)
            reply = proto.recv_msg(c._sock)
            c._sock.settimeout(None)
            assert reply["ok"] is False and "error" in reply
            assert c.ping()

    def test_no_card_daemon_raises_without_cpu(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OptimizerDaemon(socket_path=str(tmp_path / "nc.sock"))
        assert not (tmp_path / "nc.sock").exists()

    def test_devices_refused_before_the_socket(self, tmp_path, monkeypatch):
        """``devices=2`` is the daemon's default mesh: a request naming no
        devices runs on 2 logical CPU shards, equal to the unsharded run;
        ``--devices 2`` asks for the logical devices and passes the
        default on."""
        from repro_torch.hostdev import host_device_count
        d = start(tmp_path, devices=2, checkpoint_every=10_000)
        try:
            with client(d) as c:
                res = c.optimize(SMALL, timeout=WAIT)
            assert fingerprint(res) == fingerprint(many(SMALL))
        finally:
            stop(d)
        seen = {}

        class Fake:
            def __init__(self, **kw):
                seen.update(kw)

            def serve_forever(self):
                pass

        monkeypatch.setattr(server, "OptimizerDaemon", Fake)
        assert server.main(["--socket", str(tmp_path / "dv.sock"),
                            "--devices", "2", "--device", "cpu"]) == 0
        assert (seen["devices"], seen["device"]) == (2, "cpu")
        assert host_device_count() >= 2


# ============================================================= backpressure

def wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    pytest.fail(what)


class TestBackpressure:
    def test_shed_reasons(self, tmp_path):
        gate = threading.Event()
        d = start(tmp_path, "bp.sock", queue_depth=1, tenant_inflight=1,
                  worker_gate=gate)
        seeded = PlanCache()
        ref = many(SMALL[:1], cache=seeded)
        ref_warm = many(SMALL[:1], cache=seeded)
        outcomes: dict[str, object] = {}

        def send(name: str, tenant: str):
            try:
                with client(d, tenant=tenant) as c:
                    outcomes[name] = fingerprint(c.optimize(SMALL[:1],
                                                            timeout=WAIT))
            except DaemonShed as e:
                outcomes[name] = ("shed", e.reason)

        try:
            t1 = threading.Thread(target=send, args=("first", "a"))
            t1.start()

            def parked():
                with d._lock:
                    return (d._tenant_inflight.get("a") == 1
                            and d._queue.empty())
            wait_until(parked, "worker never picked up the first job")
            send("same_tenant", "a")
            assert outcomes["same_tenant"] == ("shed", "tenant")
            t3 = threading.Thread(target=send, args=("queued", "b"))
            t3.start()
            wait_until(lambda: d._queue.qsize() >= 1, "b never queued")
            send("overflow", "c")
            assert outcomes["overflow"] == ("shed", "queue")
            gate.set()
            t1.join(timeout=WAIT)
            t3.join(timeout=WAIT)
            assert not t1.is_alive() and not t3.is_alive()
            assert outcomes["first"] == fingerprint(ref)
            assert outcomes["queued"] == fingerprint(ref_warm)
        finally:
            gate.set()
            stop(d)


    def test_queue_wait_covers_a_held_worker(self, tmp_path):
        """Two tenants' requests wait behind a worker held by the gate:
        STATS' ``queue_wait_s`` p95 is at least the hold."""
        gate = threading.Event()
        d = start(tmp_path, "qw.sock", worker_gate=gate)
        hold = 0.3
        done = []

        def send(tenant: str):
            with client(d, tenant=tenant) as c:
                done.append(c.optimize(SMALL[:1], timeout=WAIT))

        try:
            ts = [threading.Thread(target=send, args=(t,)) for t in "ab"]
            for t in ts:
                t.start()

            def admitted():
                with d._lock:
                    return sum(d._tenant_inflight.values()) == 2
            wait_until(admitted, "the two requests were never admitted")
            time.sleep(hold)
            gate.set()
            for t in ts:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in ts) and len(done) == 2
            with client(d) as c:
                st = c.stats()
            assert st["queue_wait_s"]["p95"] >= hold
            assert st["queue_wait_s"]["p50"] <= st["queue_wait_s"]["p95"] \
                <= st["queue_wait_s"]["p99"]
        finally:
            gate.set()
            stop(d)


# ==================================================== drain and checkpoints

class TestDrainAndCheckpoint:
    def test_drain_request_checkpoints_and_closes(self, tmp_path):
        ckpt = str(tmp_path / "plans.plancache")
        pol = str(tmp_path / "plans.policy")
        d = start(tmp_path, "dr.sock", cache_file=ckpt, policy_file=pol,
                  checkpoint_every=10_000)
        c = client(d)
        c.optimize(SMALL, timeout=WAIT)
        c.drain()
        c.close()
        assert d._stopped.wait(WAIT)
        assert not os.path.exists(d.address)
        loaded = PlanCache.load(ckpt)
        assert not loaded.stale_load and len(loaded) == len(SMALL)
        table = PolicyTable.load(pol)
        assert not table.stale_load and table.stats.observations == 0
        assert len(table) == len(d.policy) >= 1

    def test_draining_daemon_rejects_new_work(self, tmp_path):
        d = start(tmp_path, "rj.sock")
        d._draining.set()
        reply = d._optimize_request({"op": "optimize", "tenant": "x",
                                     "graphs": []})
        assert reply["ok"] is False and "draining" in reply["error"]
        assert d._stopped.wait(WAIT)

    def test_checkpoint_under_load_is_atomic(self, tmp_path):
        ckpt = str(tmp_path / "hot.plancache")
        d = start(tmp_path, "at.sock", cache_file=ckpt, checkpoint_every=1)
        stop_ev = threading.Event()
        bad: list[str] = []

        def reader():
            while not stop_ev.is_set():
                if os.path.exists(ckpt):
                    if PlanCache.load(ckpt).stale_load:
                        bad.append("stale/torn checkpoint observed")
                        return
                time.sleep(0.001)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        try:
            with client(d) as c:
                for g in SMALL:
                    c.optimize([g], timeout=WAIT)
        finally:
            stop_ev.set()
            t.join(timeout=WAIT)
            stop(d)
        assert not t.is_alive() and not bad
        final = PlanCache.load(ckpt)
        assert not final.stale_load and len(final) == len(SMALL)

    def _park_one_job(self, d):
        outcomes: dict[str, object] = {}

        def send(name, tenant):
            try:
                with client(d, tenant=tenant) as c:
                    outcomes[name] = fingerprint(c.optimize(SMALL[:1],
                                                            timeout=WAIT))
            except DaemonError as e:
                outcomes[name] = ("err", getattr(e, "retryable", False),
                                  str(e))

        t = threading.Thread(target=send, args=("held", "a"))
        t.start()

        def holding():
            with d._lock:
                return d._current_job is not None
        wait_until(holding, "worker never picked up the job")
        return t, outcomes, send

    def test_drain_timeout_forces_exit_and_answers_queued(self, tmp_path):
        gate = threading.Event()
        d = start(tmp_path, "fd.sock", worker_gate=gate)
        try:
            t1, outcomes, send = self._park_one_job(d)
            t2 = threading.Thread(target=send, args=("queued", "b"))
            t2.start()
            wait_until(lambda: d._queue.qsize() >= 1, "b never queued")
            t0 = time.monotonic()
            d.drain(timeout=0.3)
            assert time.monotonic() - t0 < 5.0
            assert d._drain_forced
            t2.join(timeout=WAIT)
            assert outcomes["queued"][0] == "err"
            assert outcomes["queued"][1] is True
            assert "forced drain" in outcomes["queued"][2]
            gate.set()
            t1.join(timeout=WAIT)
            assert not t1.is_alive()
            assert outcomes["held"] == fingerprint(many(SMALL[:1]))
            assert d._stopped.wait(WAIT)
        finally:
            gate.set()

    def test_second_signal_forces_drain(self, tmp_path):
        gate = threading.Event()
        d = start(tmp_path, "sg.sock", worker_gate=gate)
        try:
            t1, _, _ = self._park_one_job(d)
            d._on_signal()
            time.sleep(0.2)
            assert not d._stopped.is_set()
            d._on_signal()
            assert d._stopped.wait(WAIT)
            assert d._drain_forced
            gate.set()
            t1.join(timeout=WAIT)
            assert not t1.is_alive()
        finally:
            gate.set()


# ============================================================== daemon faults

class TestDaemonFaults:
    def test_worker_crash_then_retry_identical_plan(self, tmp_path):
        ref = many(SMALL)
        faults.install(FaultPlan(rules=(FaultRule("worker", 1),)))
        d = start(tmp_path, "wc.sock")
        try:
            with client(d) as c:
                with pytest.raises(DaemonError, match="worker crashed") as ei:
                    c.optimize(SMALL, timeout=WAIT)
                assert ei.value.retryable
                rs = c.optimize(SMALL, retries=2, timeout=WAIT)
                assert fingerprint(rs) == fingerprint(ref)
                assert c.stats()["worker_restarts"] == 1
        finally:
            faults.uninstall()
            stop(d)

    def test_chunk_fault_is_a_structured_error_then_bit_identical(
            self, tmp_path):
        """A fault in the middle of a pipelined flight answers a
        non-retryable error; the worker, the cache and the engines stay
        usable, and the resent request is bit for bit the clean run."""
        ref = many(SMALL, pipeline=True)
        d = start(tmp_path, "cf.sock")
        cfg = OptimizerConfig(pipeline=True)
        try:
            with client(d) as c:
                faults.install(FaultPlan(rules=(FaultRule("chunk", 5),)))
                with pytest.raises(DaemonError, match="InjectedFault") as ei:
                    c.optimize(SMALL, config=cfg, retries=2, timeout=WAIT)
                assert not getattr(ei.value, "retryable", False)
                assert faults.fired() == ["chunk@5:raise"]
                assert len(d.cache) == 0
                rs = c.optimize(SMALL, config=cfg, timeout=WAIT)
                assert [(r.cost, plan_shape(r.plan), r.counters.evaluated,
                         r.algorithm) for r in rs] == \
                    [(r.cost, plan_shape(r.plan), r.counters.evaluated,
                      r.algorithm) for r in ref]
                st = c.stats()
                assert st["errors"] == 1 and st["worker_restarts"] == 0
        finally:
            faults.uninstall()
            stop(d)

    def test_request_deadline_timeout_is_structured(self, tmp_path):
        gate = threading.Event()
        d = start(tmp_path, "to.sock", worker_gate=gate)
        try:
            with client(d) as c:
                t0 = time.monotonic()
                with pytest.raises(DaemonError, match="deadline") as ei:
                    c.optimize(SMALL[:1], timeout=WAIT,
                               config=OptimizerConfig(deadline_s=0.05))
                assert ei.value.retryable
                assert time.monotonic() - t0 < WAIT
        finally:
            gate.set()
            stop(d)

    def test_stalled_socket_raises_frame_timeout(self, tmp_path):
        d = start(tmp_path, "st.sock")
        try:
            c = client(d)
            faults.install(FaultPlan(rules=(
                FaultRule("socket_send", 2, "stall", 1.0),)))
            with pytest.raises(FrameTimeout):
                c._call({"op": "ping"}, timeout=0.25)
            faults.uninstall()
            c.close()
        finally:
            faults.uninstall()
            stop(d)

    def test_daemon_reports_degraded_results(self, tmp_path):
        d = start(tmp_path, "dg.sock")
        try:
            with client(d) as c:
                rs = c.optimize(SMALL, timeout=WAIT,
                                config=OptimizerConfig(deadline_s=1e-4))
                assert c.last_meta["degraded"] >= 1
                assert sum(1 for r in rs if "degraded" in r.info) == \
                    c.last_meta["degraded"]
                for g, r in zip(SMALL, rs):
                    validate_plan(r.plan, g)
                    assert float(r.cost) <= float(goo.solve(g).cost) + 1e-4
                assert len(d.cache) == len(rs) - c.last_meta["degraded"]
        finally:
            stop(d)

    def test_connect_failure_is_daemon_error_with_cause(self, tmp_path):
        with pytest.raises(DaemonError, match="could not connect") as ei:
            DaemonClient(socket_path=str(tmp_path / "missing.sock"),
                         connect_timeout=0.2)
        assert isinstance(ei.value.__cause__, OSError)


def test_daemon_process_survives_faults_and_drains(tmp_path):
    """``python -m repro_torch.daemon`` with ``REPRO_FAULTS``: the first
    request gets a retryable error, a pipelined request meets the chunk
    fault, the next one is bit for bit the in-process run; SIGTERM drains
    it (exit 0) to a cache file that serves every query as a hit, and a
    policy file."""
    sock, ckpt = str(tmp_path / "p.sock"), str(tmp_path / "p.plancache")
    pol = str(tmp_path / "p.policy")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_FAULTS="worker@1:raise;chunk@5:raise")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.daemon", "--socket", sock,
         "--cache-file", ckpt, "--policy-file", pol, "--device", "cpu"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        with DaemonClient(socket_path=sock, connect_timeout=WAIT) as c:
            with pytest.raises(DaemonError, match="worker crashed") as ei:
                c.optimize(SMALL, timeout=WAIT)
            assert ei.value.retryable
            cfg = OptimizerConfig(pipeline=True)
            with pytest.raises(DaemonError, match="InjectedFault"):
                c.optimize(SMALL, config=cfg, timeout=WAIT)
            rs = c.optimize(SMALL, config=cfg, retries=2, timeout=WAIT)
            assert fingerprint(rs) == fingerprint(many(SMALL))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        proc.stdout.close()
        proc.stderr.close()
    loaded = PlanCache.load(ckpt)
    assert not loaded.stale_load
    assert all(loaded.get(g) is not None for g in SMALL)
    assert not PolicyTable.load(pol).stale_load


def test_kernel_library_loads_once_under_threads(monkeypatch):
    """``kernels.build.library()`` from more threads than cores, with a
    short switch interval: one build-and-load, every thread the same
    library, ``totals()`` counting it once (the daemon's worker and a
    caller's thread may race the first load)."""
    from repro_torch.kernels import build
    loads, lib = [], object()

    def fake_load():
        loads.append(threading.get_ident())
        time.sleep(0.02)                   # widen the race window
        build._COUNTS["loads"] += 1
        build._LIB = lib
        return lib
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_load", fake_load)
    monkeypatch.setattr(build, "_COUNTS", {"loads": 0, "builds": 0})
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.library()))
               for _ in range(4 * (os.cpu_count() or 1))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and len(got) == len(threads)
    assert all(x is lib for x in got)
    assert build.totals() == {"keys": 1, "compiles": 0, "retraces": 0}


# ====================================================== across the packages

@pytest.fixture(scope="module")
def warm_reference():
    """Compile the reference's executables for these shapes once, so its
    daemon answers inside the waits (the executable cache is per
    process)."""
    for algorithm in ("auto", "dpsub"):
        rbatch.optimize_many(R_SMALL, algorithm)


def raw_optimize(c, graphs_wire, cfg_wire=None):
    msg = {"op": "optimize", "tenant": c.tenant, "graphs": graphs_wire}
    if cfg_wire is not None:
        msg["config"] = cfg_wire
    return c._call(msg, timeout=WAIT)


def key_tree(d):
    """The nested key sets of a reply (lists of dicts by their first)."""
    if isinstance(d, dict):
        return {k: key_tree(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [key_tree(d[0])]
    return None


def assert_same_replies(ours, theirs, graphs):
    assert key_tree(ours) == key_tree(theirs)
    for k in ("ok", "flights", "lattice", "solo", "cache_hits", "degraded"):
        assert ours[k] == theirs[k], k
    for g, a, b in zip(graphs, ours["results"], theirs["results"]):
        assert (a["algorithm"], a["evaluated"], a["ccp"], a["levels"]) == \
            (b["algorithm"], b["evaluated"], b["ccp"], b["levels"])
        assert math.isclose(a["cost"], b["cost"], rel_tol=REL)
        if a["plan"] != b["plan"]:
            pa = proto.plan_shape_from_wire(a["plan"], g)
            pb = proto.plan_shape_from_wire(b["plan"], g)
            print(f"rounding tie: {pa.cost!r} vs {pb.cost!r}")
            assert math.isclose(cost_plan(pa, g).cost, cost_plan(pb, g).cost,
                                rel_tol=REL)


@pytest.mark.parametrize("client_pkg", ["reference", "port"])
def test_clients_cross_packages(tmp_path, warm_reference, client_pkg):
    """One package's client against both daemons: equal replies (keys,
    flights, hits, degraded, results), cold and warm, and STATS with the
    same keys."""
    ours = OptimizerDaemon(socket_path=str(tmp_path / "port.sock"),
                           policy=PolicyTable(), device="cpu")
    theirs = RDaemon(socket_path=str(tmp_path / "ref.sock"),
                     policy=RPolicyTable())
    ours.start()
    theirs.start()
    cls = RClient if client_pkg == "reference" else DaemonClient
    wires = [proto.graph_to_wire(g) for g in SMALL]
    try:
        with cls(socket_path=ours.address, connect_timeout=WAIT,
                 tenant="x") as co, \
                cls(socket_path=theirs.address, connect_timeout=WAIT,
                    tenant="x") as ct:
            for cfg in (None, OptimizerConfig(algorithm="dpsub").to_wire(),
                        None):
                a = raw_optimize(co, wires, cfg)
                b = raw_optimize(ct, wires, cfg)
                assert_same_replies(a, b, SMALL)
            assert a["cache_hits"] == len(SMALL)
            # decoded by the client's package: same plans, costs in REL
            da = co.optimize(R_SMALL if cls is RClient else SMALL,
                             timeout=WAIT)
            db = ct.optimize(R_SMALL if cls is RClient else SMALL,
                             timeout=WAIT)
            assert [plan_shape(r.plan) for r in da] == \
                [plan_shape(r.plan) for r in db]
            sa, sb = co.stats(), ct.stats()
        # the port's STATS are the reference's plus ``queue_wait_s``
        assert key_tree(sa) == {**key_tree(sb), "queue_wait_s": {
            "p50": None, "p95": None, "p99": None}}
        for k in ("requests", "queries", "flights", "shed", "errors",
                  "tenants", "plancache"):
            assert sa[k] == sb[k], k
        assert sa["policy"]["observations"] == sb["policy"]["observations"]
        assert sa["exec"]["retraces"] == 0
    finally:
        stop(ours)
        theirs.drain()
        assert theirs._stopped.wait(WAIT)
