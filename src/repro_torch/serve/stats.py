"""Serving observability: admission counters, batch occupancy, latency.

One :class:`ServingStats` instance per
:class:`~repro_torch.serve.graphserve.GraphServer` accumulates the
server's whole history; its :meth:`ServingStats.snapshot` dict is what
the server exposes as ``server.stats()`` and injects into every batch's
``schedule_stats["serving"]`` block — queue depth, cumulative
admitted/rejected/queued counts, batch occupancy (real rows over padded
bucket rows), executed step counts, footprint high water vs budget, and
end-to-end p50/p95/p99 latency percentiles.

Latencies land in a **bounded** :class:`repro_torch.obs.metrics.Histogram`
(the process-wide ``serve.latency_seconds`` instrument on the default
log-spaced ladder), not an unbounded list: a server that has answered a
million queries holds the same few dozen bucket counts as one that
answered ten, and the reported p50/p95/p99 are within one bucket width
of the exact order statistics.  Admission decisions and batch occupancy
are mirrored into the registry too.
"""
from __future__ import annotations

import numpy as np

from .. import obs

__all__ = ["ServingStats"]


class ServingStats:
    """Mutable counters; ``snapshot()`` renders the serving stats block."""

    def __init__(self) -> None:
        self.admitted = 0            # queries admitted (incl. from queue)
        self.rejected = 0            # queries refused outright
        self.queued = 0              # queue *events* (a query that waits)
        self.queue_depth = 0         # currently waiting
        self.completed = 0
        self.deadline_exceeded = 0   # queries expired before execution
        self.cancelled = 0           # queries withdrawn by the caller
        self.batch_failures = 0      # device batches that raised
        self.retry_after_rejections = 0   # queue-full rejections (hinted)
        self.batches = 0             # device batches executed
        self.steps_executed = 0      # step invocations (Σ iterations × waves)
        self.footprint_high_water_bytes = 0
        self.budget_bytes: int | None = None
        self._occupancy: list[tuple[int, int]] = []   # (real, padded)
        # per-server view of the shared bounded latency instrument:
        # constant memory in query count, percentile error ≤ one bucket
        self._latency = obs.Histogram("serve.latency_seconds")

    # -- recording -----------------------------------------------------
    def record_admit(self) -> None:
        self.admitted += 1
        obs.metrics.counter("serve.admitted").inc()

    def record_reject(self) -> None:
        self.rejected += 1
        obs.metrics.counter("serve.rejected").inc()

    def record_queue(self) -> None:
        self.queued += 1
        obs.metrics.counter("serve.queued").inc()

    def record_deadline_exceeded(self) -> None:
        self.deadline_exceeded += 1
        obs.metrics.counter("serve.deadline_exceeded").inc()

    def record_cancel(self) -> None:
        self.cancelled += 1
        obs.metrics.counter("serve.cancelled").inc()

    def record_batch_failure(self) -> None:
        self.batch_failures += 1
        obs.metrics.counter("serve.batch_failures").inc()

    def record_retry_after(self) -> None:
        self.retry_after_rejections += 1
        obs.metrics.counter("serve.retry_after").inc()

    def record_batch(self, real: int, padded: int, steps: int) -> None:
        self.batches += 1
        self.steps_executed += int(steps)
        self._occupancy.append((int(real), int(padded)))
        m = obs.metrics
        m.counter("serve.batches").inc()
        m.counter("serve.steps_executed").inc(int(steps))
        if padded > 0:
            m.histogram("serve.batch_occupancy",
                        edges=tuple(i / 10 for i in range(11))).observe(real / padded)

    def record_latency(self, seconds: float) -> None:
        self.completed += 1
        self._latency.observe(float(seconds))
        obs.metrics.histogram("serve.latency_seconds").observe(float(seconds))

    # -- reporting -----------------------------------------------------
    def latency_percentiles(self) -> dict:
        if not self._latency.count:
            return dict(p50=None, p95=None, p99=None)
        return dict(p50=self._latency.percentile(50),
                    p95=self._latency.percentile(95),
                    p99=self._latency.percentile(99))

    def retry_after_hint(self) -> float:
        """Seconds a queue-full-rejected caller should wait before
        resubmitting: the observed median end-to-end latency (one
        in-flight batch typically retires by then), floored so a cold
        server still hints something actionable."""
        p50 = self._latency.percentile(50) if self._latency.count else None
        return max(float(p50), 0.05) if p50 is not None else 0.05

    def batch_occupancy(self) -> float | None:
        """Mean fraction of bucket rows occupied by real queries."""
        if not self._occupancy:
            return None
        return float(np.mean([r / p for r, p in self._occupancy if p > 0]))

    def snapshot(self) -> dict:
        return dict(
            queue_depth=self.queue_depth,
            admitted=self.admitted,
            rejected=self.rejected,
            queued=self.queued,
            completed=self.completed,
            deadline_exceeded=self.deadline_exceeded,
            cancelled=self.cancelled,
            batch_failures=self.batch_failures,
            retry_after_rejections=self.retry_after_rejections,
            batches=self.batches,
            steps_executed=self.steps_executed,
            batch_occupancy=self.batch_occupancy(),
            batch_sizes=[r for r, _ in self._occupancy],
            bucket_sizes=[p for _, p in self._occupancy],
            latency_s=self.latency_percentiles(),
            footprint_high_water_bytes=self.footprint_high_water_bytes,
            budget_bytes=self.budget_bytes,
        )
