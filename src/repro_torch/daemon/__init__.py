"""Cross-process optimizer daemon of the port: a persistent, multi-tenant
front end for the port's streaming optimizer
(``core.service.StreamOptimizer``), wire-compatible with the reference's
daemon (``docs/daemon.md``): a client of either package talks to a daemon
of either.

In-process use starts each process with a cold ``PlanCache`` and loads the
CUDA library anew; the daemon keeps both warm for every client, and one
shared ``PlanCache`` (checkpointed to disk, pickle-free) turns one
client's optimized queries into every other client's cache hits.

    python -m repro_torch.daemon --socket /tmp/repro.sock \\
        --cache-file plans.plancache [--device cpu]

Layout:

  * ``protocol`` — length-prefixed JSON framing and pure-literal wire
    codecs for join graphs, configs (``OptimizerConfig.to_wire``) and
    results;
  * ``server`` — ``OptimizerDaemon``: socket accept loop, bounded request
    queue with per-tenant admission control and SHED backpressure, one
    optimizer worker thread (supervised), periodic atomic cache and policy
    checkpoints, STATS, graceful SIGTERM drain;
  * ``client`` — ``DaemonClient`` and a one-shot command line
    (``python -m repro_torch.daemon.client``).
"""
from .client import DaemonClient, DaemonError, DaemonShed
from .protocol import FrameTimeout
from .server import OptimizerDaemon

__all__ = ["DaemonClient", "DaemonError", "DaemonShed", "FrameTimeout",
           "OptimizerDaemon"]
