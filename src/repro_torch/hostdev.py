"""Logical CPU devices for the sharded paths (standard library only).

The port's counterpart of ``repro.hostdev``.  The reference emulates
several host devices through an XLA flag read once at start-up; the port
needs no flag: a ``core.shard.DeviceMesh`` may name one torch device
several times, and each entry is a *logical shard* with its own tensors.
``ensure_host_devices(n)`` sets how many logical CPU devices
``core.shard.take_devices(backend="cpu")`` hands out (1 by default), so a
CPU test or a daemon started with ``--devices N`` can ask for ``N`` of
them as the reference's callers ask for ``N`` emulated devices.
"""
from __future__ import annotations

_HOST_DEVICES: int | None = None      # None: no count pinned, 1 device


def ensure_host_devices(n: int | None) -> bool:
    """Ask for ``n`` logical CPU devices; return True when the count is
    (now or already) pinned.

    No-op when ``n`` is falsy or 1 (the default count).  A count pinned
    before wins, as an explicit ``XLA_FLAGS`` pin does in the reference:
    if it is smaller than what a caller later needs, ``take_devices``
    raises with the actual count.
    """
    global _HOST_DEVICES
    if not n or n <= 1:
        return False
    if _HOST_DEVICES is None:
        _HOST_DEVICES = int(n)
    return True


def host_device_count() -> int:
    """Logical CPU devices ``take_devices(backend="cpu")`` hands out."""
    return _HOST_DEVICES or 1
