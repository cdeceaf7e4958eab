"""Validated ``REPRO_*`` environment knobs — one loud front door.

Every runtime tuning knob the framework reads from the environment goes
through this module.  Two properties the scattered ``os.environ.get``
reads it replaces did not have:

* **Malformed values fail loudly.**  ``REPRO_DIRECTION_BETA=fast``
  raises ``ValueError: REPRO_DIRECTION_BETA='fast' is not a valid
  float`` at the read site instead of silently falling back to a
  default (or crashing later with a bare ``float()`` traceback that
  never names the knob).
* **Unknown names fail at the call site.**  Reading a knob that is not
  in the :data:`KNOWN` registry is a programming error — it means a new
  knob was added without documenting it here, defeating the point of
  centralizing.  The registry doubles as the single inventory a reader
  (or ``docs/resilience.md``) can consult.

The helpers deliberately import nothing beyond ``os``.
"""
from __future__ import annotations

import os

__all__ = ["KNOWN", "env_float", "env_int", "env_flag", "env_str"]

#: Every environment knob the framework reads, with a one-line meaning.
#: Reading an undeclared name raises — add the knob here (and to the
#: docs) before using it.
KNOWN: dict[str, str] = {
    "REPRO_FAULTS": "fault-injection spec string (see repro.core.faults)",
    "REPRO_CHAOS_WALL_RATIO":
        "chaos smoke gate: faulted wall / fault-free wall upper bound",
    "REPRO_DIRECTION_BETA": "direction-switch cost ratio override",
    "REPRO_DIRECTION_HYSTERESIS": "direction re-arm band override",
    "REPRO_HETERO_NOISE_FLOOR_S":
        "hetero split refresh noise floor (seconds)",
    "REPRO_HETERO_HOST_RATIO": "device/host throughput ratio prior",
    "REPRO_SMOKE_OVERLAP_FLOOR": "perf smoke: staging overlap floor",
    "REPRO_HETERO_WALL_RATIO": "hetero smoke: wall-ratio gate",
    "REPRO_DIRECTION_WALL_RATIO": "direction smoke: wall-ratio gate",
    "REPRO_SMOKE_OVERHEAD_RATIO": "serve smoke: batching overhead gate",
    "REPRO_TRACE": "tracer sink path (enables span/instant capture)",
    "REPRO_TRACE_TORCH": "mirror spans as torch.profiler.record_function ranges",
}


def _raw(name: str) -> str | None:
    if name not in KNOWN:
        raise KeyError(
            f"unknown knob {name!r}: declare it in repro_torch.core.knobs.KNOWN "
            "(and document it) before reading it")
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    return raw.strip()


def env_float(name: str, default: float) -> float:
    """``float(os.environ[name])`` with loud validation."""
    raw = _raw(name)
    if raw is None:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a valid float") from None


def env_int(name: str, default: int) -> int:
    raw = _raw(name)
    if raw is None:
        return int(default)
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a valid integer") from None


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: 1/true/yes/on vs 0/false/no/off (case-insensitive)."""
    raw = _raw(name)
    if raw is None:
        return bool(default)
    low = raw.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ValueError(
        f"{name}={raw!r} is not a valid flag "
        "(use 1/true/yes/on or 0/false/no/off)")


def env_str(name: str, default: str | None = None) -> str | None:
    raw = _raw(name)
    return default if raw is None else raw
