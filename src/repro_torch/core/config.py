"""Optimizer configuration: one frozen object for every entry point.

The port's own copy of ``repro.core.config``: the same constants, the same
``OptimizerConfig`` fields and validation, the same legacy-kwarg shim
(``resolve_config``/``alias_kwarg``) and the same wire form
(``to_wire``/``from_wire``, the daemon's request config), so a config built
for the reference means the same thing here and a wire dict from either
package builds an equal config in the other.
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

# Fields that cross the daemon wire.  ``cache``/``mesh``/``policy`` are
# process-local and excluded: a config carrying any of them cannot
# serialize (``to_wire`` raises); the daemon owns its own shared cache and
# policy table.
_WIRE_FIELDS = ("algorithm", "chunk", "devices", "pipeline", "max_flight",
                "cyc_cap", "enum", "lattice", "deadline_s")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Canonical knob set (field meanings as in the reference package).

    * ``algorithm`` — {auto, mpdp, mpdp_tree, mpdp_general, dpsub, dpsize,
      dpccp}; ``auto``/``mpdp`` dispatch by topology.
    * ``chunk`` — lanes per evaluate/filter chunk.
    * ``max_flight`` — sub-batch (flight) size cap.
    * ``cyc_cap`` — max cyclomatic number for the MPDP-general block pass.
    * ``cache`` — optional ``plancache.PlanCache`` probed before any device
      work; process-local, never wired.
    * ``devices`` / ``mesh`` — shard the batched paths over a
      ``shard.DeviceMesh`` (``devices=N``: the first N devices of the
      entry point's device type); ``mesh`` is process-local, never wired.
    * ``pipeline`` — pipelined level loops (``None`` defers to the
      ``REPRO_PIPELINE`` environment flag).
    * ``enum`` — level enumeration: "unrank" (paper Alg.5) | "expand".
    * ``lattice`` — ``engine.optimize`` shards the query's own lane space
      over ``devices``/``mesh`` (``core.lattice``).
    * ``policy`` — optional ``policy.PolicyTable`` consulted by the batched
      and streaming dispatchers under ``auto``/``mpdp`` and fed each
      flight's telemetry; ``None`` (the default) is the static dispatch.
      Process-local, never wired.
    * ``deadline_s`` — cooperative anytime deadline in seconds, checked at
      DP-level boundaries; on expiry the remaining levels are abandoned
      and a best-effort plan is returned (the committed memo levels
      stitched with a GOO completion, cost <= plain GOO) with
      ``OptimizeResult.info["degraded"]`` saying why.  ``None`` (the
      default) disables the checks.
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

    def replace(self, **changes) -> "OptimizerConfig":
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------- wire ----
    def to_wire(self) -> dict:
        """Pure-literal dict of the wire fields (the daemon request form).
        Raises when ``cache``, ``mesh`` or ``policy`` is set: they are live
        process-local objects with no wire form."""
        if self.cache is not None:
            raise ValueError("OptimizerConfig.cache is process-local and "
                             "cannot be wired; the daemon owns the shared "
                             "plan cache")
        if self.mesh is not None:
            raise ValueError("OptimizerConfig.mesh is process-local and "
                             "cannot be wired; pass devices=N instead")
        if self.policy is not None:
            raise ValueError("OptimizerConfig.policy is process-local and "
                             "cannot be wired; the daemon owns the shared "
                             "policy table")
        return {f: getattr(self, f) for f in _WIRE_FIELDS}

    @staticmethod
    def from_wire(d: dict) -> "OptimizerConfig":
        """Inverse of ``to_wire``; unknown keys raise (a version-skewed
        client must fail loudly, not silently drop knobs)."""
        unknown = set(d) - set(_WIRE_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown OptimizerConfig wire fields: {sorted(unknown)}")
        return OptimizerConfig(**{f: d[f] for f in _WIRE_FIELDS if f in d})


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
