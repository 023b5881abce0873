"""Production mesh builders.  The port of ``repro.launch.mesh``.

Single pod: (16, 16) = (data, model), 256 devices.
Multi-pod:  (2, 16, 16) = (pod, data, model), 512 devices; the thin `pod`
axis composes with `data` for batch/gradient reduction, `model` stays
inside a pod.

A ``Mesh`` names its axes and their sizes and holds its devices (from
``core.shard.take_devices``, which never truncates: a (16, 16) mesh on one
card raises with the actual count).  ``Mesh(shape, axes)`` without
devices is an abstract mesh: the sharding rules read only its axes.
"""
from __future__ import annotations

import math


class Mesh:
    """``shape``: axis name -> size, in axis order; ``axis_names``;
    ``devices``: the flat device list (row-major over the axes), or None
    for an abstract mesh."""

    def __init__(self, shape, axis_names, devices=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        if devices is not None and len(devices) != self.size:
            raise ValueError(f"{len(devices)} devices for a mesh of {self.size}")
        self.devices = None if devices is None else list(devices)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _make_mesh(shape, axes, backend=None):
    from ..core.shard import take_devices      # the optimizer's device list
    return Mesh(shape, axes, take_devices(math.prod(shape), backend=backend))


def make_production_mesh(*, multi_pod: bool = False, backend=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, backend)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), backend=None):
    """Tiny mesh over the local devices of ``backend`` (cuda by default;
    ``"cpu"`` for the logical devices of ``hostdev.ensure_host_devices``)."""
    return _make_mesh(shape, axes, backend)


def dp_axes(mesh) -> tuple:
    """Axes used for batch/data parallelism on this mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
