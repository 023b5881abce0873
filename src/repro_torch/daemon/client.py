"""``DaemonClient``: the client library and one-shot command line of the
port's daemon (the port's own copy of ``repro.daemon.client``; either
client talks to either package's daemon).

Library use::

    from repro_torch.daemon import DaemonClient
    with DaemonClient(socket_path="/tmp/repro.sock", tenant="svc-a") as c:
        results = c.optimize(graphs)                  # list[OptimizeResult]
        results = c.optimize(graphs, config=OptimizerConfig(deadline_s=0.5))
        c.stats()["exec"]["compiles"]                 # daemon telemetry

``optimize`` raises ``DaemonShed`` when admission control rejects the
request (bounded queue full, or this tenant already has its in-flight cap
admitted; back off and retry) and ``DaemonError`` for request-level
failures.  Both leave the connection usable.  Results are decoded against
the *local* graphs (plan shapes re-costed by ``cost_plan``), so
``OptimizeResult.cost`` is bit for bit what the daemon's engines computed.

The command line (``python -m repro_torch.daemon.client``) sends one
optimize request over the canonical ``mixed_stream`` workload and prints
a JSON report.  The client runs no device work: it needs only sockets,
the graph builders and the plan re-coster.
"""
from __future__ import annotations

import random
import socket
import time

from . import protocol as proto


class DaemonError(RuntimeError):
    """Request-level failure reported by the daemon (connection stays up)."""


class DaemonShed(DaemonError):
    """Admission control rejected the request; back off and retry.

    ``reason`` is ``"queue"`` (bounded request queue full) or ``"tenant"``
    (this tenant already has its in-flight cap admitted).
    """

    def __init__(self, reason: str):
        super().__init__(f"request shed by daemon ({reason})")
        self.reason = reason


class DaemonClient:
    """One connection to an ``OptimizerDaemon`` (unix socket or TCP).

    ``connect_timeout`` bounds the initial connect retry loop — daemon
    startup races (socket not bound yet) are retried, not errors.
    """

    def __init__(self, socket_path: str | None = None,
                 host: str | None = None, port: int | None = None,
                 tenant: str = "default", connect_timeout: float = 10.0):
        if socket_path is None and host is None:
            raise ValueError("pass socket_path= (unix) or host=/port= (tcp)")
        self.tenant = tenant
        self.last_meta: dict | None = None     # wall_s/flights/cache_hits of
        self._socket_path = socket_path        # the last optimize
        self._host, self._port = host, port
        self._connect_timeout = connect_timeout
        self._connect()

    def _connect(self) -> None:
        deadline = time.monotonic() + self._connect_timeout
        last_err: OSError | None = None
        while True:
            try:
                if self._socket_path is not None:
                    self._sock = socket.socket(socket.AF_UNIX,
                                               socket.SOCK_STREAM)
                    self._sock.connect(self._socket_path)
                else:
                    self._sock = socket.create_connection(
                        (self._host, self._port))
                return
            except OSError as e:
                last_err = e
                if time.monotonic() >= deadline:
                    where = (self._socket_path if self._socket_path is not None
                             else f"{self._host}:{self._port}")
                    raise DaemonError(
                        f"could not connect to {where} within "
                        f"{self._connect_timeout}s") from last_err
                time.sleep(0.05)

    def _reconnect(self) -> None:
        self.close()
        self._connect()

    # --------------------------------------------------------------- plumbing
    def _call(self, msg: dict, timeout: float | None = None) -> dict:
        """One request/reply round trip.  ``timeout`` bounds the socket
        recv (a stalled daemon raises ``protocol.FrameTimeout`` instead of
        hanging forever); the socket is restored to blocking after."""
        try:
            if timeout is not None:
                self._sock.settimeout(timeout)
            proto.send_msg(self._sock, msg)
            reply = proto.recv_msg(self._sock)
        finally:
            if timeout is not None:
                self._sock.settimeout(None)
        if reply is None:
            raise DaemonError("daemon closed the connection")
        if not reply.get("ok"):
            if reply.get("shed"):
                raise DaemonShed(reply.get("reason", "?"))
            err = DaemonError(reply.get("error", "unknown daemon error"))
            err.retryable = bool(reply.get("retryable"))
            raise err
        return reply

    # ------------------------------------------------------------------- api
    def optimize(self, graphs, config=None, *, timeout: float | None = None,
                 retries: int = 0, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0) -> list:
        """Optimize ``graphs`` on the daemon; returns ``OptimizeResult``\\ s
        in input order (plans re-costed locally — bit-identical to
        in-process).  Request-level metadata lands on ``self.last_meta``.

        ``timeout`` bounds each round trip at the socket (a stalled daemon
        raises ``FrameTimeout``).  ``retries > 0`` makes the call resilient:
        ``DaemonShed`` and retryable daemon errors (worker crash, forced
        drain, request deadline) back off exponentially with jitter and
        resend; a reset connection reconnects and resends.  The request is
        idempotent — the daemon recomputes (or serves from its plan cache),
        so a resend can only repeat work, never corrupt state.
        """
        msg = {"op": "optimize", "tenant": self.tenant,
               "graphs": [proto.graph_to_wire(g) for g in graphs]}
        if config is not None:
            msg["config"] = config.to_wire()
        attempt, delay = 0, backoff_s
        while True:
            try:
                reply = self._call(msg, timeout=timeout)
                break
            except (DaemonShed, DaemonError, ConnectionResetError,
                    BrokenPipeError) as e:
                if isinstance(e, proto.FrameTimeout):
                    raise          # a stalled socket is the caller's signal
                retryable = (isinstance(e, (DaemonShed, ConnectionResetError,
                                            BrokenPipeError))
                             or getattr(e, "retryable", False))
                if not retryable or attempt >= retries:
                    raise
                attempt += 1
                if isinstance(e, (ConnectionResetError, BrokenPipeError)):
                    self._reconnect()
                else:
                    time.sleep(delay * random.uniform(0.5, 1.0))
                    delay = min(delay * 2, max_backoff_s)
        self.last_meta = {k: reply[k] for k in
                          ("wall_s", "flights", "lattice", "solo",
                           "cache_hits", "degraded") if k in reply}
        return [proto.result_from_wire(d, g)
                for d, g in zip(reply["results"], graphs)]

    def stats(self) -> dict:
        return self._call({"op": "stats"})

    def ping(self) -> bool:
        return bool(self._call({"op": "ping"}).get("pong"))

    def drain(self) -> None:
        """Ask the daemon to shut down gracefully (drain + checkpoint)."""
        self._call({"op": "drain"})

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def main(argv=None) -> int:
    """One-shot client: optimize the canonical ``mixed_stream`` workload
    and print a JSON report (costs + daemon stats) to stdout."""
    import argparse
    import json
    ap = argparse.ArgumentParser(
        prog="repro_torch.daemon.client",
        description="one-shot daemon client over the canonical mixed stream")
    ap.add_argument("--socket", type=str, default=None)
    ap.add_argument("--tcp", type=str, default=None, metavar="HOST:PORT")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenant", type=str, default="cli")
    ap.add_argument("--repeat", type=int, default=1,
                    help="send the same request this many times")
    ap.add_argument("--stats", action="store_true",
                    help="include a daemon STATS snapshot in the report")
    args = ap.parse_args(argv)
    if (args.socket is None) == (args.tcp is None):
        ap.error("exactly one of --socket / --tcp is required")

    from ..workloads.generators import mixed_stream
    graphs = mixed_stream(args.queries, args.seed)
    host = port = None
    if args.tcp is not None:
        host, _, port = args.tcp.rpartition(":")
        port = int(port)
    report = {"queries": args.queries, "seed": args.seed,
              "tenant": args.tenant, "rounds": []}
    with DaemonClient(socket_path=args.socket, host=host, port=port,
                      tenant=args.tenant) as c:
        for _ in range(args.repeat):
            results = c.optimize(graphs)
            report["rounds"].append(dict(
                c.last_meta, costs=[float(r.cost) for r in results]))
        if args.stats:
            report["stats"] = c.stats()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
