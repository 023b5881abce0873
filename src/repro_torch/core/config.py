"""Optimizer configuration: one frozen object for every entry point.

The port's own copy of ``repro.core.config``: the same constants, the same
``OptimizerConfig`` fields and validation, and the same legacy-kwarg shim
(``resolve_config``/``alias_kwarg``), so a config built for the reference
means the same thing here.  Fields the port does not serve yet
(``devices``/``mesh``, ``policy``, ``deadline_s``) are accepted here and
refused by the entry point that would consume them.
"""
from __future__ import annotations

import dataclasses
import warnings

CHUNK = 1 << 15          # lanes per evaluate/filter chunk
CYC_CAP_DEFAULT = 24     # max cyclomatic number handled by the vector path
MAX_FLIGHT = 32          # sub-batch / flight cap: bounds memo memory


class _Unset:
    """Sentinel distinguishing "kwarg not passed" from every real value
    (``None`` is a meaningful value for devices/mesh/cache/pipeline)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "<unset>"


UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Canonical knob set (field meanings as in the reference package).

    * ``algorithm`` — {auto, mpdp, mpdp_tree, mpdp_general, dpsub, dpsize,
      dpccp}; ``auto``/``mpdp`` dispatch by topology.
    * ``chunk`` — lanes per evaluate/filter chunk.
    * ``max_flight`` — sub-batch (flight) size cap.
    * ``cyc_cap`` — max cyclomatic number for the MPDP-general block pass.
    * ``cache``, ``devices``, ``mesh``, ``pipeline``, ``enum``, ``lattice``,
      ``policy``, ``deadline_s`` — carried for config compatibility.
    """

    algorithm: str = "auto"
    chunk: int = CHUNK
    cache: object | None = None
    devices: int | None = None
    mesh: object | None = None
    pipeline: bool | None = None
    max_flight: int = MAX_FLIGHT
    cyc_cap: int = CYC_CAP_DEFAULT
    enum: str = "unrank"
    lattice: bool = False
    policy: object | None = None
    deadline_s: float | None = None

    def __post_init__(self):
        if self.chunk <= 0:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")
        if self.max_flight <= 0:
            raise ValueError(
                f"max_flight must be positive, got {self.max_flight}")
        if self.enum not in ("unrank", "expand"):
            raise ValueError(f"unknown enum mode {self.enum!r} "
                             "(expected 'unrank' or 'expand')")
        if self.devices is not None and self.mesh is not None:
            raise ValueError("pass devices= or mesh=, not both")


def resolve_config(config: OptimizerConfig | None, **legacy) -> OptimizerConfig:
    """Normalize an entry point's (config=, legacy kwargs) pair: legacy
    values equal to ``UNSET`` were not passed; passing both spellings
    raises."""
    passed = {k: v for k, v in legacy.items() if v is not UNSET}
    if config is not None:
        if passed:
            raise ValueError(
                "pass config= or the legacy kwargs, not both "
                f"(got config plus {sorted(passed)})")
        if not isinstance(config, OptimizerConfig):
            raise TypeError(f"config must be an OptimizerConfig, "
                            f"got {type(config).__name__}")
        return config
    return OptimizerConfig(**passed)


def alias_kwarg(new, old, old_name: str, new_name: str):
    """Resolve a deprecated-alias pair: returns the effective value, warning
    on the old spelling and raising when both were passed."""
    if old is UNSET:
        return new
    if new is not UNSET:
        raise ValueError(f"pass {new_name}= or the deprecated {old_name}=, "
                         "not both")
    warnings.warn(f"{old_name}= is deprecated; use {new_name}=",
                  DeprecationWarning, stacklevel=3)
    return old
