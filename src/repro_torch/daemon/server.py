"""``OptimizerDaemon``: the persistent multi-tenant optimizer process.

The port's own copy of ``repro.daemon.server``, serving the port's
``core.service.StreamOptimizer`` on ``device`` (``cuda`` by default, or
``cpu`` when asked).  One daemon process owns the warm state and serves
every client:

  * the **CUDA kernel library** (``kernels.build``), built or loaded once
    per process: no build after serving starts (STATS' ``exec``);
  * one shared **plan cache**: a ``PlanCache`` probed before any device
    work, so canonically-equal queries across clients resolve without an
    engine; checkpointed atomically to ``cache_file`` every
    ``checkpoint_every`` optimize requests and again on drain;
  * optionally one shared learned **policy table** (``policy_file``),
    checkpointed beside the cache;
  * one **optimizer worker thread**: all device work runs in it, in
    request order, on the worker's own current CUDA stream, pulling from a
    bounded request queue.

**Admission control / backpressure.**  The request queue is bounded
(``queue_depth``) and each tenant may have at most ``tenant_inflight``
requests admitted at once.  A request that would exceed either bound gets
an immediate ``SHED`` reply (``{"ok": false, "shed": true, "reason":
"queue"|"tenant"}``) instead of unbounded buffering.  Admission happens in
the per-connection handler thread, which then waits on its own job only
(bounded by the request's ``deadline_s`` when it has one), so one slow
tenant cannot stall another tenant's SHED, STATS or ping replies.

**Request lifecycle** (per ``optimize``): the handler checks admission and
enqueues the raw message; the worker decodes graphs and config
(``protocol`` codecs), substitutes the daemon's shared cache and policy,
runs ``StreamOptimizer(config=..., device=...).optimize_stream`` and
encodes the reply; the handler wakes and writes it back.  Results are
bit for bit the in-process ``StreamOptimizer``'s over the same request
sequence, because the graph and config codecs round-trip exactly.

**Telemetry.**  A ``stats`` request answers with the daemon's counts
(requests, queries, shed, errors, flights, checkpoints, per tenant, the
plan cache, the flights' ``telemetry`` roll-up, ``exec``) and with p50,
p95 and p99 over the last ``history`` requests of ``request_wall_s`` (the
worker's wall for a request: decode and run, not the reply's encode),
``flight_wall_s`` and ``queue_wait_s``: a request's wait from admission
to the worker's pickup, behind the jobs ahead of it.  With the span
recorder on (``core.telemetry.enable``) the worker records that wait as
the span ``daemon.queue`` and its job as ``daemon.decode``,
``daemon.run`` and ``daemon.encode``, all under the request id stamped
at admission, which the spans of the engines under ``daemon.run`` share.

**Faults.**  A crashed worker (an injected ``worker`` fault) is re-spawned
in place and its job answered with a retryable error; an exception inside
a job (an injected ``chunk`` fault) is answered with a structured error
and leaves the worker, the device and the cache usable.

**Shutdown.**  ``drain()`` (SIGTERM, SIGINT, or a ``drain`` request):
stop admitting, let the queue empty and in-flight replies flush, final
checkpoint, close the socket.  ``serve_forever`` then returns so the
process exits 0.

**Meshes.**  ``devices=N`` (``--devices N``) is the daemon's default mesh
size and ``mesh=`` its default mesh: a request that names no ``devices``
runs on them, one that pins ``devices`` keeps its pin.  A request pinning
more devices than ``device``'s type has gets the mesh's error as its
structured reply.
"""
from __future__ import annotations

import os
import queue
import signal
import socket
import threading
import time
from collections import deque

from . import protocol as proto
from ..core import faults
from ..core import telemetry as _telemetry
from ..core.config import OptimizerConfig
from ..core.engine import resolve_device
from ..core.plancache import PlanCache
from ..core.policy import PolicyTable
from ..core.service import StreamOptimizer
from ..hostdev import ensure_host_devices
from ..kernels import build


class _Job:
    """One admitted optimize request: raw message in, encoded reply out."""

    __slots__ = ("msg", "tenant", "done", "reply", "t_admit", "rid")

    def __init__(self, msg: dict, tenant: str):
        self.msg = msg
        self.tenant = tenant
        self.done = threading.Event()
        self.reply: dict | None = None
        self.t_admit = 0          # perf_counter_ns at admission
        self.rid = 0              # the request's span id (telemetry)


class OptimizerDaemon:
    """Socket front-end around ``core.service.StreamOptimizer``.

    Address is either a unix-domain ``socket_path`` or a TCP
    ``(host, port)`` (``port=0`` binds an ephemeral port; read the actual
    one from ``.address`` after ``start()``).  ``device`` is where every
    request runs (``cuda`` unless the caller names another; raises without
    a card).  ``devices``/``mesh`` are the default mesh of a request that
    pins no ``devices`` (see the module docstring).

    ``worker_gate`` is a test-only hook: when set to a ``threading.Event``,
    the worker waits on it before picking up each job — letting the
    backpressure tests fill the bounded queue deterministically.
    """

    def __init__(self, socket_path: str | None = None,
                 host: str | None = None, port: int = 0,
                 cache=None, cache_file: str | None = None,
                 checkpoint_every: int = 32, queue_depth: int = 8,
                 tenant_inflight: int = 2, history: int = 4096,
                 devices: int | None = None, mesh=None,
                 policy=None, policy_file: str | None = None,
                 worker_gate: threading.Event | None = None,
                 drain_timeout: float | None = None, device=None):
        if socket_path is None and host is None:
            raise ValueError("pass socket_path= (unix) or host=/port= (tcp)")
        self.device = resolve_device(device)
        self._devices, self._mesh = devices, mesh
        self._socket_path = socket_path
        self._host, self._port = host, port
        self._cache_file = cache_file
        self._checkpoint_every = checkpoint_every
        self._queue_depth = queue_depth
        self._tenant_inflight_cap = tenant_inflight
        self._worker_gate = worker_gate
        self._drain_timeout = drain_timeout

        if cache is None:
            if cache_file and os.path.exists(cache_file):
                cache = PlanCache.load(cache_file)
            else:
                cache = PlanCache()
        self.cache = cache

        # shared learned-policy table (same lifecycle as the plan cache:
        # optional warm state, checkpointed alongside it).  ``policy=None``
        # with no ``policy_file`` means learning is off and every request
        # runs the static dispatch — bit-identical to a policy-free daemon.
        self._policy_file = policy_file
        if policy is None and policy_file:
            if os.path.exists(policy_file):
                policy = PolicyTable.load(policy_file)
            else:
                policy = PolicyTable()
        self.policy = policy

        self._queue: queue.Queue[_Job | None] = queue.Queue(maxsize=queue_depth)
        self._lock = threading.Lock()
        self._tenant_inflight: dict[str, int] = {}
        self._tenant_totals: dict[str, dict] = {}
        self._draining = threading.Event()
        self._drain_claimed = False
        self._force_drain = threading.Event()
        self._drain_forced = False
        self._stopped = threading.Event()
        self._current_job: _Job | None = None      # held by the worker
        self._worker_restarts = 0
        self._listen: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self.address: tuple | str | None = None

        # telemetry (mutated under self._lock unless noted)
        self._started_at = 0.0
        self._requests = 0
        self._queries = 0
        self._shed = 0
        self._errors = 0
        self._flights = 0
        self._since_checkpoint = 0
        self._checkpoints = 0
        self._request_walls: deque[float] = deque(maxlen=history)
        self._queue_waits: deque[float] = deque(maxlen=history)
        self._flight_walls: deque[float] = deque(maxlen=history)
        # flight-telemetry roll-up (telemetry.aggregate shape, summed
        # across every finalized flight of every request)
        self._telemetry = {"flights": 0, "queries": 0, "evaluated_lanes": 0,
                           "ccp_lanes": 0, "chunks": 0, "retraces": 0}

    # ------------------------------------------------------------ lifecycle -
    def start(self) -> None:
        """Bind, listen, and start the accept + worker threads (returns
        immediately; use ``serve_forever`` for a blocking main loop)."""
        if self._socket_path is not None:
            if os.path.exists(self._socket_path):
                os.unlink(self._socket_path)       # stale socket from a crash
            self._listen = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listen.bind(self._socket_path)
            self.address = self._socket_path
        else:
            self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listen.bind((self._host, self._port))
            self.address = self._listen.getsockname()
        self._listen.listen(64)
        self._started_at = time.perf_counter()
        for target, name in ((self._accept_loop, "daemon-accept"),
                             (self._worker_main, "daemon-worker"),
                             (self._drain_watcher, "daemon-drain")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def serve_forever(self, install_signals: bool = True) -> None:
        """``start()`` then block until drained.  With ``install_signals``
        SIGTERM/SIGINT trigger a graceful drain; a *second* signal forces
        the drain (answer queued jobs with a retryable error, checkpoint,
        exit) instead of waiting out in-flight work (main-thread only)."""
        self.start()
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._on_signal)
        # timed wait so the main thread keeps servicing signal handlers
        while not self._stopped.wait(timeout=0.2):
            pass

    def _on_signal(self, *_) -> None:
        if self._draining.is_set():
            self._force_drain.set()                # second signal: force it
        else:
            self._draining.set()

    def _drain_watcher(self) -> None:
        """Runs the actual drain once anything sets ``_draining`` — a
        ``drain`` request, a signal handler, or an explicit ``drain()``."""
        self._draining.wait()
        self.drain()

    def drain(self, timeout: float | None = None) -> None:
        """Graceful shutdown: stop admitting, flush the queue and in-flight
        replies, checkpoint the cache, close the socket.  Idempotent; a
        second caller just waits for the first to finish.

        ``timeout`` (default: the ``drain_timeout`` passed at construction)
        bounds the flush wait.  On expiry — or when ``_force_drain`` is set
        by a second SIGTERM/SIGINT — the drain is *forced*: queued-but-
        unstarted jobs are answered with a retryable shutdown error so no
        client hangs, the final checkpoint still runs, and the process
        exits.  The job the worker holds right now finishes normally."""
        if timeout is None:
            timeout = self._drain_timeout
        self._draining.set()
        with self._lock:
            claimed, self._drain_claimed = self._drain_claimed, True
        if claimed:                                # someone else is draining
            self._stopped.wait()
            return
        # wait for admitted work to finish (bounded queue -> bounded wait)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                idle = self._queue.empty() and \
                    not any(self._tenant_inflight.values())
            if idle:
                break
            if self._force_drain.is_set() or (
                    deadline is not None and time.monotonic() >= deadline):
                self._drain_forced = True
                break
            time.sleep(0.01)
        if self._drain_forced:
            while True:                            # flush unstarted jobs
                try:
                    job = self._queue.get_nowait()
                except queue.Empty:
                    break
                if job is None:
                    continue
                job.reply = {"ok": False, "retryable": True,
                             "error": "daemon shutting down (forced drain)"}
                with self._lock:
                    self._tenant_inflight[job.tenant] -= 1
                job.done.set()
        self._queue.put(None)                      # worker sentinel
        if self._listen is not None:
            try:
                self._listen.close()
            except OSError:
                pass
        if self._socket_path and os.path.exists(self._socket_path):
            try:
                os.unlink(self._socket_path)
            except OSError:
                pass
        self._checkpoint(force=True)
        self._stopped.set()

    stop = drain

    # ---------------------------------------------------------- accept loop -
    def _accept_loop(self) -> None:
        while not self._draining.is_set():
            try:
                conn, _ = self._listen.accept()
            except OSError:                        # listen socket closed
                return
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 name="daemon-conn", daemon=True)
            t.start()

    def _handle_conn(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    msg = proto.recv_msg(conn)
                except (proto.ProtocolError, OSError):
                    return
                if msg is None:                    # clean EOF
                    return
                try:
                    reply = self._dispatch(msg)
                except Exception as e:             # request-level error:
                    with self._lock:               # connection stays usable
                        self._errors += 1
                    reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                try:
                    proto.send_msg(conn, reply)
                except OSError:
                    return
                if msg.get("op") == "drain":
                    self._draining.set()
                    return

    # ------------------------------------------------------------- dispatch -
    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "stats":
            return self._stats_reply()
        if op == "drain":
            return {"ok": True, "draining": True}
        if op == "optimize":
            return self._optimize_request(msg)
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _optimize_request(self, msg: dict) -> dict:
        tenant = str(msg.get("tenant", "default"))
        job = _Job(msg, tenant)
        with self._lock:
            if self._draining.is_set():
                return {"ok": False, "error": "daemon is draining"}
            if self._tenant_inflight.get(tenant, 0) >= self._tenant_inflight_cap:
                self._shed += 1
                return {"ok": False, "shed": True, "reason": "tenant",
                        "tenant": tenant}
            self._tenant_inflight[tenant] = \
                self._tenant_inflight.get(tenant, 0) + 1
        job.t_admit = time.perf_counter_ns()
        job.rid = _telemetry.new_request()
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            with self._lock:
                self._tenant_inflight[tenant] -= 1
                self._shed += 1
            return {"ok": False, "shed": True, "reason": "queue"}
        # a request that carries a deadline gets a *bounded* handler wait:
        # the worker's engines enforce the deadline cooperatively (anytime
        # results), so the wait only expires when something is truly wedged
        # — answer a structured retryable TIMEOUT instead of hanging
        dl = (msg.get("config") or {}).get("deadline_s")
        wait = None if not dl else float(dl) + max(float(dl) * 0.2, 1.0)
        if not job.done.wait(wait):
            return {"ok": False, "timeout": True, "retryable": True,
                    "error": f"request deadline ({dl}s) exceeded"}
        return job.reply

    # --------------------------------------------------------------- worker -
    def _worker_main(self) -> None:
        """Worker supervision: a crashed worker thread (a bug escaping the
        per-job handler, or an injected ``worker`` fault) is re-spawned in
        place — the job it held is answered with a retryable error so its
        client can resend, and everything still queued survives."""
        while True:
            try:
                self._worker_loop()
                return                             # clean sentinel exit
            except BaseException as e:
                with self._lock:
                    job, self._current_job = self._current_job, None
                    self._worker_restarts += 1
                if job is not None:
                    job.reply = {"ok": False, "retryable": True,
                                 "error": f"optimizer worker crashed: {e!r}"}
                    with self._lock:
                        self._tenant_inflight[job.tenant] -= 1
                    job.done.set()

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            with self._lock:
                self._current_job = job
            faults.fire("worker")                  # injected crash: escapes
            if self._worker_gate is not None:      # to _worker_main
                self._worker_gate.wait()
            t_pick = time.perf_counter_ns()
            _telemetry.record("daemon.queue", job.t_admit, t_pick, job.rid)
            try:
                with _telemetry.request(job.rid):
                    job.reply = self._run_job(job, t_pick * 1e-9)
            except Exception as e:
                with self._lock:
                    self._errors += 1
                job.reply = {"ok": False,
                             "error": f"{type(e).__name__}: {e}"}
            finally:
                with self._lock:
                    self._current_job = None
                    self._tenant_inflight[job.tenant] -= 1
                    self._queue_waits.append((t_pick - job.t_admit) * 1e-9)
                job.done.set()

    def _run_job(self, job: _Job, t0: float) -> dict:
        with _telemetry.span("daemon.decode"):
            cfg = OptimizerConfig.from_wire(job.msg.get("config") or {})
            graphs = [proto.graph_from_wire(d)
                      for d in job.msg.get("graphs", [])]
        # substitute the daemon-owned shared state; a request that pins
        # devices= keeps its pin, otherwise the daemon's default mesh rules
        cfg = cfg.replace(
            cache=self.cache, lattice=False, policy=self.policy,
            mesh=self._mesh if cfg.devices is None else None,
            devices=cfg.devices if cfg.devices is not None
            else (self._devices if self._mesh is None else None))
        hits0 = self.cache.stats.hits
        with _telemetry.span("daemon.run"):
            results, report = StreamOptimizer(
                config=cfg, device=self.device).optimize_stream(graphs)
        wall = time.perf_counter() - t0
        tele = report.telemetry_summary()
        with self._lock:
            self._requests += 1
            self._queries += len(graphs)
            self._flights += len(report.flights)
            self._request_walls.append(wall)
            self._flight_walls.extend(f.wall_s for f in report.flights)
            for k in self._telemetry:
                self._telemetry[k] += int(tele.get(k, 0))
            tt = self._tenant_totals.setdefault(
                job.tenant, {"requests": 0, "queries": 0, "shed": 0})
            tt["requests"] += 1
            tt["queries"] += len(graphs)
            self._since_checkpoint += 1
        self._checkpoint()
        with _telemetry.span("daemon.encode"):
            wires = [proto.result_to_wire(r) for r in results]
        return {"ok": True,
                "results": wires,
                "wall_s": wall,
                "flights": len(report.flights),
                "lattice": report.lattice,
                "solo": report.solo,
                "cache_hits": self.cache.stats.hits - hits0,
                "degraded": sum(1 for r in results if "degraded" in r.info)}

    def _checkpoint(self, force: bool = False) -> None:
        """Atomic cache + policy checkpoint (worker/drain only — both
        ``save``\\ s rename into place, so concurrent ``load``\\ s never
        see a torn file)."""
        if not (self._cache_file or self._policy_file):
            return
        with self._lock:
            due = force or self._since_checkpoint >= self._checkpoint_every
            if not due:
                return
            self._since_checkpoint = 0
            self._checkpoints += 1
        if self._cache_file:
            self.cache.save(self._cache_file)
        if self._policy_file and self.policy is not None:
            self.policy.save(self._policy_file)

    # ------------------------------------------------------------ telemetry -
    @staticmethod
    def _percentiles(xs, ps=(50, 95, 99)) -> dict:
        if not xs:
            return {f"p{p}": 0.0 for p in ps}
        import numpy as np
        arr = np.asarray(xs, float)
        return {f"p{p}": float(np.percentile(arr, p)) for p in ps}

    def _stats_reply(self) -> dict:
        with self._lock:
            out = {
                "ok": True,
                "uptime_s": time.perf_counter() - self._started_at,
                "requests": self._requests,
                "queries": self._queries,
                "shed": self._shed,
                "errors": self._errors,
                "worker_restarts": self._worker_restarts,
                "drain_forced": self._drain_forced,
                "flights": self._flights,
                "queue_depth": self._queue_depth,
                "queued": self._queue.qsize(),
                "tenants": {t: dict(v)
                            for t, v in sorted(self._tenant_totals.items())},
                "checkpoints": self._checkpoints,
                "request_wall_s": self._percentiles(self._request_walls),
                "queue_wait_s": self._percentiles(self._queue_waits),
                "flight_wall_s": self._percentiles(self._flight_walls),
                "plancache": {
                    "entries": len(self.cache),
                    "hits": self.cache.stats.hits,
                    "misses": self.cache.stats.misses,
                    "inserts": self.cache.stats.inserts,
                    "evictions": self.cache.stats.evictions,
                },
                "telemetry": dict(self._telemetry),
            }
            if self.policy is not None:
                out["policy"] = self.policy.summary()
        # the reference's executable-cache keys, filled from the kernel
        # library's build counts: no build after serving starts
        out["exec"] = build.totals()
        return out


def main(argv=None) -> int:
    """``python -m repro_torch.daemon`` entry point."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.daemon",
        description="persistent multi-tenant join-order optimizer daemon")
    ap.add_argument("--socket", type=str, default=None,
                    help="unix-domain socket path to serve on")
    ap.add_argument("--tcp", type=str, default=None, metavar="HOST:PORT",
                    help="TCP address to serve on (PORT 0 = ephemeral)")
    ap.add_argument("--cache-file", type=str, default=None,
                    help="persisted PlanCache path (loaded when present; "
                         "checkpointed atomically while serving)")
    ap.add_argument("--checkpoint-every", type=int, default=32,
                    help="optimize requests between cache checkpoints")
    ap.add_argument("--queue-depth", type=int, default=8,
                    help="bounded request queue: beyond this, SHED")
    ap.add_argument("--tenant-inflight", type=int, default=2,
                    help="max admitted requests per tenant at once")
    ap.add_argument("--devices", type=int, default=None,
                    help="default mesh size for sharded passes (on cpu, "
                         "that many logical devices)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device every request runs on (cuda, or "
                         "cpu for the plain PyTorch versions)")
    ap.add_argument("--policy-file", type=str, default=None,
                    help="persisted PolicyTable path: enables learned "
                         "dispatch policies, loaded when present and "
                         "checkpointed atomically alongside the plan cache")
    ap.add_argument("--drain-timeout", type=float, default=None,
                    help="bound the graceful-drain flush wait: on expiry "
                         "queued jobs get a retryable error and the daemon "
                         "checkpoints + exits (a second SIGTERM does the "
                         "same immediately)")
    args = ap.parse_args(argv)
    if (args.socket is None) == (args.tcp is None):
        ap.error("exactly one of --socket / --tcp is required")

    ensure_host_devices(args.devices)   # logical CPU devices for --device cpu
    faults.install_from_env()          # REPRO_FAULTS= chaos harness, if any

    host = port = None
    if args.tcp is not None:
        host, _, port = args.tcp.rpartition(":")
        port = int(port)
    daemon = OptimizerDaemon(
        socket_path=args.socket, host=host, port=port or 0,
        cache_file=args.cache_file, checkpoint_every=args.checkpoint_every,
        queue_depth=args.queue_depth, tenant_inflight=args.tenant_inflight,
        devices=args.devices, policy_file=args.policy_file,
        drain_timeout=args.drain_timeout, device=args.device)
    daemon.serve_forever()
    return 0
