"""Daemon wire protocol: length-prefixed JSON frames, pure-literal codecs.

The port's own copy of ``repro.daemon.protocol``, frame for frame and key
for key, so a client of either package talks to a daemon of either.

**Framing.**  Every message is one frame: a 4-byte big-endian unsigned
length followed by that many bytes of UTF-8 JSON.  Frames are capped at
``MAX_FRAME`` (a malformed or hostile length prefix must not allocate
gigabytes); a peer that closes mid-frame raises ``ProtocolError``, a close
*between* frames is a clean EOF (``recv_msg`` returns ``None``).  The
``"socket_send"`` fault site can stall a send mid-frame.

**Literal discipline.**  The payloads are JSON only, the same pickle-free
stance as ``PlanCache.save``: a hostile client can produce garbage, never
code execution.  Graphs cross the wire as their log2 statistics
(``joingraph.graph_to_wire``/``graph_from_wire``, re-exported here; the
round trip is bit-identical); plans cross as their *shape* only (nested
[left, right] lists over leaf bitmaps) and are re-costed on the receiving
side's graph, as a plan-cache hit is.  ``OptimizeResult.cost`` crosses as
the f32-exact float the server's engines computed, so daemon results
compare bit for bit with the in-process ``StreamOptimizer``.

**Requests** (``op`` selects; all other fields per op):

  optimize   {"op": "optimize", "tenant": str, "config": <to_wire dict>,
              "graphs": [<graph wire>, ...]}
  stats      {"op": "stats"}
  ping       {"op": "ping"}
  drain      {"op": "drain"}        # graceful shutdown request

**Responses**: ``{"ok": true, ...}`` on success; ``{"ok": false,
"shed": true, "reason": ...}`` when admission control rejects (queue or
per-tenant saturation: back off and retry); ``{"ok": false, "error":
...}`` on a request-level error (the connection stays usable).
"""
from __future__ import annotations

import json
import socket
import struct
import time

from ..core import faults
from ..core.joingraph import graph_from_wire, graph_to_wire  # noqa: F401
from ..core.plan import Counters, OptimizeResult, Plan, cost_plan

MAX_FRAME = 64 << 20     # 64 MiB: a ~1000-relation heuristic-tier graph is
                         # a few hundred KiB; anything near this is garbage

_LEN = struct.Struct(">I")


class ProtocolError(ConnectionError):
    """Malformed frame: oversized length prefix or EOF mid-frame."""


class FrameTimeout(ProtocolError):
    """The peer stalled mid-frame past the socket's receive deadline.

    Distinct from a bare ``socket.timeout`` so callers can tell a stalled
    *daemon* (retryable with a fresh connection) from their own misuse;
    subclassing ``ProtocolError`` keeps every existing handler working.
    """


def send_msg(sock: socket.socket, obj) -> None:
    """Serialize ``obj`` to one length-prefixed JSON frame and send it."""
    data = json.dumps(obj, separators=(",", ":")).encode()
    if len(data) > MAX_FRAME:
        raise ProtocolError(f"frame too large: {len(data)} > {MAX_FRAME}")
    buf = _LEN.pack(len(data)) + data
    if faults.active():
        rule = faults.check("socket_send")
        if rule is not None and rule.action == "stall":
            # injected mid-frame stall: half the frame, a pause, the rest —
            # the peer's recv deadline (FrameTimeout) is what's under test
            mid = max(len(buf) // 2, 1)
            sock.sendall(buf[:mid])
            time.sleep(rule.delay_s)
            sock.sendall(buf[mid:])
            return
    sock.sendall(buf)


def recv_msg(sock: socket.socket):
    """Receive one frame; ``None`` on clean EOF at a frame boundary."""
    head = _recv_exactly(sock, _LEN.size, eof_ok=True)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length > MAX_FRAME:
        raise ProtocolError(f"frame too large: {length} > {MAX_FRAME}")
    body = _recv_exactly(sock, length, eof_ok=False)
    return json.loads(body.decode())


def _recv_exactly(sock: socket.socket, n: int, *, eof_ok: bool):
    chunks, got = [], 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except TimeoutError as e:
            raise FrameTimeout(
                f"peer stalled mid-frame ({got}/{n} bytes)") from e
        if not chunk:
            if eof_ok and got == 0:
                return None
            raise ProtocolError(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


# =========================================================== result codec ==

def plan_shape_to_wire(p):
    """Plan tree -> nested [left, right] lists over leaf bitmaps (ints) —
    the JSON twin of ``plancache._encode_plan``."""
    if p.is_leaf:
        return p.rel_set
    return [plan_shape_to_wire(p.left), plan_shape_to_wire(p.right)]


def plan_shape_from_wire(e, g):
    """Rebuild the plan from its wire shape, re-costing canonically on
    ``g``'s exact stats (``cost_plan`` — the plan-cache hit discipline)."""

    def decode(x):
        if isinstance(x, int):
            return Plan(rel_set=x, cost=0.0, rows_log2=0.0)
        l, r = x
        lp, rp = decode(l), decode(r)
        return Plan(rel_set=lp.rel_set | rp.rel_set, cost=0.0,
                    rows_log2=0.0, left=lp, right=rp)

    return cost_plan(decode(e), g)


def result_to_wire(r) -> dict:
    d = {"cost": float(r.cost),
         "algorithm": r.algorithm,
         "levels": r.levels,
         "wall_s": r.wall_s,
         "evaluated": r.counters.evaluated,
         "ccp": r.counters.ccp,
         "plan": plan_shape_to_wire(r.plan)}
    # degraded metadata (deadline stitch) is already pure literals: pass it
    # through so clients see best-effort results; ``redispatched`` (a
    # sharded flight re-run on one device) is the reference's key
    if "degraded" in r.info:
        d["degraded"] = r.info["degraded"]
    if r.info.get("redispatched"):
        d["redispatched"] = True
    return d


def result_from_wire(d: dict, g):
    r = OptimizeResult(
        plan=plan_shape_from_wire(d["plan"], g),
        cost=d["cost"],
        counters=Counters(evaluated=d["evaluated"], ccp=d["ccp"]),
        algorithm=d["algorithm"],
        wall_s=d["wall_s"],
        levels=d["levels"])
    if "degraded" in d:
        r.info["degraded"] = d["degraded"]
    if d.get("redispatched"):
        r.info["redispatched"] = True
    return r
