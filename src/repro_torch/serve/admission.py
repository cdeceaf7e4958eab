"""Admission control for the graph-query server (membudget pricing).

The controller answers one question per query: does admitting it keep
the *priced* device footprint under the serving budget?  The footprint
model is the streaming executor's (:mod:`repro_torch.core.membudget`),
lifted to serving granularity:

    total = Σ resident plan bytes            (graphs held hot)
          + Σ in-flight query state bytes    (admitted, per tenant)
          + batch padding reservations       (bucket rows − real rows)

* resident plan bytes — ``plan.resident_device_bytes``: the in-core
  context, or for streamed plans the cross-wave residents plus the
  double-buffered worst wave.
* query state bytes — :func:`repro_torch.core.membudget.batch_state_bytes`
  of one ``init_state`` row (``STATE_COPIES`` live copies).

Decisions are three-valued: **admit** (charge now), **queue** (would
fit alone but not right now — wait for in-flight work to retire), and
**reject** (could *never* fit: resident + query exceeds the budget, or
the query alone exceeds its tenant's cap).  Tenant caps are enforced by
a :class:`~repro_torch.core.membudget.TenantLedger`, so one tenant's
burst queues behind its own cap instead of starving the rest.

``max_queue`` bounds the wait line itself: a query that would QUEUE
when the line is already full is rejected instead — load-shedding with
a ``retry_after_s`` hint (the server attaches the observed median
latency) rather than unbounded buildup.
"""
from __future__ import annotations

from ..core.membudget import MemoryBudget, TenantLedger

__all__ = ["AdmissionController", "ADMIT", "QUEUE", "REJECT"]

ADMIT = "admit"
QUEUE = "queue"
REJECT = "reject"


class AdmissionController:
    """Prices queries against one device budget plus per-tenant caps.

    ``budget=None`` disables the global bound (everything admits);
    tenant caps still apply.  All byte accounting is host-side model
    pricing — the controller never touches device memory itself.
    """

    def __init__(self, budget: "int | str | MemoryBudget | None" = None, *,
                 tenants: TenantLedger | None = None,
                 max_queue: int | None = None) -> None:
        self.budget = MemoryBudget.of(budget) if budget is not None else None
        if max_queue is not None and int(max_queue) < 0:
            raise ValueError(f"max_queue must be >= 0; got {max_queue!r}")
        self.max_queue = int(max_queue) if max_queue is not None else None
        self.tenants = tenants if tenants is not None else TenantLedger()
        self.resident_bytes = 0      # hot plans
        self.in_flight_bytes = 0     # admitted query rows
        self.reserved_bytes = 0      # bucket padding rows
        self.high_water_bytes = 0

    # -- accounting ----------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return self.resident_bytes + self.in_flight_bytes + self.reserved_bytes

    def headroom(self) -> float:
        if self.budget is None:
            return float("inf")
        return self.budget.total_bytes - self.total_bytes

    def _mark(self) -> None:
        self.high_water_bytes = max(self.high_water_bytes, self.total_bytes)

    def add_resident(self, nbytes: int) -> None:
        """Charge a newly hot plan.  Raises when the resident set alone
        would exceed the budget — serving cannot proceed at all then,
        and a loud failure beats admitting nothing forever."""
        nbytes = int(nbytes)
        if (self.budget is not None
                and self.resident_bytes + nbytes > self.budget.total_bytes):
            raise ValueError(
                f"resident plans would hold {self.resident_bytes + nbytes} "
                f"bytes > serving budget {self.budget.total_bytes}; raise "
                "memory_budget or register fewer/smaller graphs")
        self.resident_bytes += nbytes
        self._mark()

    # -- decisions -----------------------------------------------------
    def decide(self, tenant: str, nbytes: int) -> str:
        """ADMIT / QUEUE / REJECT for a query pricing ``nbytes``."""
        nbytes = int(nbytes)
        # could it EVER fit? (ignore transient in-flight/reserved work)
        if (self.budget is not None
                and self.resident_bytes + nbytes > self.budget.total_bytes):
            return REJECT
        if not self.tenants.fits(tenant, nbytes):
            return REJECT
        if self.budget is not None and nbytes > self.headroom():
            return QUEUE
        if not self.tenants.can_charge(tenant, nbytes):
            return QUEUE
        return ADMIT

    def queue_full(self, queue_depth: int) -> bool:
        """Whether a would-QUEUE query must be shed instead: the wait
        line already holds ``max_queue`` queries.  (Promotion from an
        existing queue slot is never shed — only new arrivals.)"""
        return self.max_queue is not None and int(queue_depth) >= self.max_queue

    def admit(self, tenant: str, nbytes: int) -> None:
        self.tenants.charge(tenant, nbytes)
        self.in_flight_bytes += int(nbytes)
        self._mark()

    def release(self, tenant: str, nbytes: int) -> None:
        self.tenants.release(tenant, nbytes)
        self.in_flight_bytes = max(0, self.in_flight_bytes - int(nbytes))

    # padding rows belong to no tenant; the batch former reserves them
    # for the duration of one device batch
    def reserve(self, nbytes: int) -> bool:
        nbytes = int(nbytes)
        if self.budget is not None and nbytes > self.headroom():
            return False
        self.reserved_bytes += nbytes
        self._mark()
        return True

    def unreserve(self, nbytes: int) -> None:
        self.reserved_bytes = max(0, self.reserved_bytes - int(nbytes))
