"""Graceful-degradation policies for the streaming executor.

The executor's recovery contract rests on the ``metadata["combine"]``
idempotence guarantee: every iteration folds partials from the
iteration-start state, so an iteration that dies anywhere can be
re-run wholesale without double-counting.  :class:`RetryPolicy` bounds
how many times and decides the *ladder* each failure class climbs:

* **generic fault** (injected or transient) → retry the iteration;
* **device OOM** → retry under an exponentially shrunk effective
  budget (re-packing waves via ``membudget.repack_waves`` — the
  per-task bound is never relaxed), then demote the offending wave's
  tasks to the host lane;
* **staging-worker death** → fail over to synchronous assembly
  (``pipeline_depth=0`` semantics) for the retried iteration, then
  permanently if the worker keeps dying;
* **host-lane failure** → retry, then run device-only
  (``host_fraction=0``).

Only a memory failure is an OOM: ``torch.cuda.OutOfMemoryError`` (by
type), an injected OOM, a host ``MemoryError``, or a runtime error
whose message says "out of memory".  Any other CUDA error — a kernel
that failed to launch, an illegal address — is a plain ``fault``: it
is retried as is and never sends the wave to the host lane's plain
kernels.

Every action increments a counter in :class:`ResilienceStats`, which
renders the ``schedule_stats["resilience"]`` block (emitted only when
faults/checkpointing are configured or a recovery actually fired, so
existing callers see unchanged keys).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .faults import InjectedOOM

__all__ = [
    "RetryPolicy", "ResilienceStats", "HostTaskError", "WorkerDeath",
    "is_oom", "classify",
]


class HostTaskError(RuntimeError):
    """A host-lane task failed; carries unit/task/iteration context so
    the failure surfaces with its blame attached instead of as a bare
    future exception reaped at fold time."""

    def __init__(self, unit: int, tasks, it: int, cause: BaseException):
        super().__init__(
            f"host-lane unit {unit} (tasks {list(tasks)[:8]}"
            f"{'...' if len(tasks) > 8 else ''}, iteration {it}) failed: "
            f"{type(cause).__name__}: {cause}")
        self.unit = unit
        self.it = it


class WorkerDeath(RuntimeError):
    """The staging worker thread died; wraps its stored exception."""

    def __init__(self, cause: BaseException):
        super().__init__(
            f"staging worker died: {type(cause).__name__}: {cause}")
        self.cause = cause


def is_oom(exc: BaseException) -> bool:
    """Does ``exc`` say that memory ran out?

    ``torch.cuda.OutOfMemoryError`` is matched by type, injected OOMs
    and host ``MemoryError`` likewise; a plain ``RuntimeError`` only by
    an "out of memory" (or "resource exhausted") message.  "CUDA error:
    an illegal memory access", a failed launch and the like are not
    OOMs, nor are the executor's own wrappers (:class:`HostTaskError`,
    :class:`WorkerDeath`) whatever their cause says."""
    if isinstance(exc, (InjectedOOM, MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    if type(exc) is not RuntimeError:
        return False
    msg = str(exc).lower()
    return ("out of memory" in msg or "resource_exhausted" in msg
            or "resource exhausted" in msg)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounds and shape of the recovery ladder.

    ``max_retries`` caps recovery attempts per iteration;
    ``backoff`` is the per-OOM effective-budget shrink factor
    (attempt *i* packs waves under ``budget × backoff**i``);
    ``demote_after`` OOMs on one iteration demote the offending wave
    to the host lane; ``failover_after`` staging-worker deaths make
    synchronous assembly permanent.
    """

    max_retries: int = 3
    backoff: float = 0.5
    demote_after: int = 2
    failover_after: int = 2

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0 < self.backoff < 1:
            raise ValueError(
                f"backoff must be in (0, 1); got {self.backoff}")


@dataclass
class ResilienceStats:
    """Counters behind ``schedule_stats["resilience"]``."""

    injected: int = 0
    detected: int = 0
    retries: int = 0
    demotions: int = 0
    failovers: int = 0
    host_failovers: int = 0
    oom_repacks: int = 0
    checkpoints: int = 0
    actions: list = field(default_factory=list)

    @property
    def fired(self) -> bool:
        return self.detected > 0 or self.checkpoints > 0

    def record(self, action: str, **ctx) -> None:
        self.actions.append(dict(action=action, **ctx))

    def snapshot(self, faults=None) -> dict:
        out = dict(
            injected=(faults.injected if faults is not None
                      else self.injected),
            detected=self.detected,
            retries=self.retries,
            demotions=self.demotions,
            failovers=self.failovers,
            host_failovers=self.host_failovers,
            oom_repacks=self.oom_repacks,
            checkpoints=self.checkpoints,
            actions=list(self.actions),
        )
        if faults is not None:
            out["fault_rules"] = faults.stats()["rules"]
        return out


def classify(exc: BaseException) -> str:
    """Failure class for the ladder: ``oom`` | ``worker`` | ``host`` |
    ``fault`` (anything else retryable)."""
    if is_oom(exc):
        return "oom"
    if isinstance(exc, WorkerDeath):
        return "worker"
    if isinstance(exc, HostTaskError):
        return "host"
    return "fault"
