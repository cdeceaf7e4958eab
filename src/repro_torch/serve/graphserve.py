"""Multi-tenant graph-query serving: resident plans, admission, batching.

The long-lived layer between compiled :class:`~repro_torch.core.engine.Plan`\\ s
and many concurrent callers — the serving analogue of the paper's
scheduler: queries are tasks, the device budget is the resource bound,
and the server multiplexes heterogeneous work (PageRank from many
seeds, multi-source BFS, k-core, CC) through a few hot graphs.

Three mechanisms compose:

* **Resident plans** — ``register_graph`` holds a graph's
  :class:`~repro_torch.core.blocks.BlockStore`; the first query of each
  (algorithm, params) builds a plan once and keeps it hot.  In-core
  plans are keyed on the graph's shape, so a *same-shape* graph binds
  the existing plan through ``plan.run(other_store)`` with zero new
  steps.  Graphs registered with a ``memory_budget=`` get a budgeted
  streaming plan instead, bound to their store.
* **Admission control** — every query is priced under the
  :mod:`repro_torch.core.membudget` footprint model (one state row ×
  ``STATE_COPIES``) and checked against the serving budget and its
  tenant's cap (:mod:`repro_torch.serve.admission`): admit, queue, or
  reject.
* **Cross-query batching** — compatible admitted queries (same graph,
  same algorithm key, batchable state) are stacked along a leading
  query axis (:func:`repro_torch.core.engine.batch_states`), padded to
  a power-of-two bucket (:func:`repro_torch.core.membudget.bucket_size`),
  and executed as ONE batch: each iteration (and each streamed wave)
  launches ``spmv_tiles``/``frontier_tiles`` once for every query of
  the batch.  Results are sliced back per query and finalized
  individually; batching is semantics-preserving (bit-identical
  int/bool attributes vs solo runs).

Plans run on the server's ``device`` (the current card unless
``device="cpu"`` is given).  Not to be confused with
:mod:`repro_torch.serve.engine`, the LM slot-batching decode engine —
that one serves token streams, this one serves graph queries.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import torch

from .. import obs
from ..algorithms.bfs import bfs_algorithm
from ..algorithms.cc import afforest_algorithm
from ..algorithms.kcore import kcore_algorithm
from ..algorithms.pagerank import pagerank_algorithm
from ..core.engine import (
    batch_states, compile_plan, context_bytes, resolve_device, unbatch_state,
)
from ..core.faults import FaultPlan
from ..core.membudget import TenantLedger, batch_state_bytes, bucket_size, tree_array_bytes
from .admission import ADMIT, QUEUE, REJECT, AdmissionController
from .stats import ServingStats

__all__ = ["GraphServer", "Query"]


@dataclass
class Query:
    """One graph query: ``Query("web", "pagerank", dict(seeds=[3]))``.

    ``params`` are algorithm arguments (``seeds``/``damping``/``tol``/
    ``max_iters`` for pagerank, ``source``/``beta``/``max_iters`` for
    bfs, ``k``/``max_iters`` for kcore, ``k_rounds``/``sample_size`` for
    cc).  The server fills ``uid``/``status``/``result``/``latency_s``;
    ``status`` moves ``new → queued|admitted → done`` (or
    ``rejected``/``expired``/``cancelled``/``failed``, with ``reason``).

    ``deadline_s`` is a per-query execution deadline measured from
    submission: a query still waiting (queued or admitted) when it
    elapses is expired instead of executed.  A query already inside a
    running batch completes — execution is synchronous, so deadlines
    bound *waiting*, not compute.  ``retry_after_s`` is filled on
    queue-full rejections: how long the caller should wait before
    resubmitting.
    """

    graph: str
    algorithm: str
    params: dict = field(default_factory=dict)
    tenant: str = "default"
    deadline_s: float | None = None
    uid: int = -1
    status: str = "new"
    reason: str | None = None
    submitted_s: float = 0.0
    latency_s: float | None = None
    retry_after_s: float | None = None
    result: Any = None
    schedule_stats: dict | None = None
    priced_bytes: int = 0


@dataclass(frozen=True)
class _AlgEntry:
    """How one query kind maps onto plans and batches.

    ``key`` identifies plan/batch compatibility (the params that change
    the step, plus the state-structure marker); ``shared_alg`` builds
    the resident plan (no per-query params — the step is shared);
    ``query_alg`` carries the query's own ``init_state``."""

    key: tuple
    shared_alg: Any
    query_alg: Any
    batchable: bool


def _reject_extras(kind: str, leftovers: dict) -> None:
    if leftovers:
        raise ValueError(f"unknown {kind} query params: {sorted(leftovers)}")


def _resolve(kind: str, params: dict) -> _AlgEntry:
    p = dict(params or {})
    if kind == "pagerank":
        damping = float(p.pop("damping", 0.85))
        tol = float(p.pop("tol", 1e-4))
        mi = int(p.pop("max_iters", 20))
        seeds = p.pop("seeds", None)
        _reject_extras(kind, p)

        def mk(s):
            return pagerank_algorithm(damping=damping, tol=tol, max_iters=mi, seeds=s)

        # seeds stay out of the key (state content shares one step) but
        # their *presence* is structural: seeded and unseeded states
        # have different leaves and must not share a batch
        return _AlgEntry(key=("pagerank", damping, tol, mi, seeds is None),
                         shared_alg=mk(None), query_alg=mk(seeds), batchable=True)
    if kind == "bfs":
        beta = int(p.pop("beta", 24))
        mi = int(p.pop("max_iters", 10_000))
        source = int(p.pop("source", 0))
        _reject_extras(kind, p)
        return _AlgEntry(key=("bfs", beta, mi),
                         shared_alg=bfs_algorithm(0, max_iters=mi, beta=beta),
                         query_alg=bfs_algorithm(source, max_iters=mi, beta=beta),
                         batchable=True)
    if kind == "kcore":
        k = int(p.pop("k"))
        mi = int(p.pop("max_iters", 10_000))
        _reject_extras(kind, p)
        alg = kcore_algorithm(k, max_iters=mi)
        return _AlgEntry(key=("kcore", k, mi), shared_alg=alg, query_alg=alg,
                         batchable=False)
    if kind == "cc":
        kr = int(p.pop("k_rounds", 2))
        ss = int(p.pop("sample_size", 1024))
        _reject_extras(kind, p)
        alg = afforest_algorithm(k_rounds=kr, sample_size=ss)
        return _AlgEntry(key=("cc", kr, ss), shared_alg=alg, query_alg=alg,
                         batchable=False)
    raise ValueError(
        f"unknown query algorithm {kind!r} (known: pagerank, bfs, kcore, cc)")


class GraphServer:
    """Serve concurrent graph queries over registered graphs.

    ``memory_budget`` bounds the priced device footprint (resident
    plans + in-flight query state); ``None`` serves unbounded.
    ``tenant_budgets``/``default_tenant_budget`` cap per-tenant
    in-flight bytes.  ``max_batch`` caps how many compatible queries
    one batch carries; ``max_queue`` how many wait for admission.
    ``faults`` arms the ``serve.query`` fault site, which fires once per
    batch.  ``device`` is where every plan runs: the current card unless
    ``"cpu"`` is given (raises when there is no card and no device).

    Synchronous execution model: :meth:`submit` prices and admits (or
    queues/rejects), :meth:`step` forms and runs one batch to
    completion, :meth:`drain` steps until everything submitted is done.
    """

    def __init__(self, *, memory_budget: "int | str | None" = None,
                 max_batch: int = 8,
                 tenant_budgets: dict | None = None,
                 default_tenant_budget: "int | str | None" = None,
                 max_queue: int | None = None,
                 faults: "str | FaultPlan | None" = None,
                 device: "str | torch.device | None" = None) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.device = resolve_device(device)
        self._faults = FaultPlan.parse(faults)
        self.admission = AdmissionController(
            memory_budget,
            tenants=TenantLedger(tenant_budgets, default_budget=default_tenant_budget),
            max_queue=max_queue)
        self._stats = ServingStats()
        if self.admission.budget is not None:
            self._stats.budget_bytes = self.admission.budget.total_bytes
        self._graphs: dict[str, tuple[Any, dict]] = {}
        self._plans: dict[tuple, Any] = {}
        self._charged: set[tuple] = set()   # (plan_key, graph) residents
        self._queue: list[Query] = []       # waiting admission, FIFO
        self._admitted: list[Query] = []    # awaiting a batch slot
        self._done: dict[int, Query] = {}
        self._uid = 0
        self.last_schedule_stats: dict | None = None

    # -- registration --------------------------------------------------
    def register_graph(self, name: str, store, **plan_kw) -> None:
        """Hold ``store`` for serving under ``name``.

        ``plan_kw`` forwards to :func:`repro_torch.core.engine.compile_plan`
        for every plan built over this graph — pass ``memory_budget=``
        here to serve the graph through the budgeted streaming executor
        (that budget is the plan's *wave* budget, distinct from the
        server's admission budget), and ``mesh=`` as well to shard its
        waves over a :class:`~repro_torch.core.distributed.DeviceMesh`
        (a batched state replicates and folds leaf-wise like any other).
        The device is the server's; a mesh's shard 0 must lie on it.
        """
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already registered")
        if "device" in plan_kw:
            raise TypeError("plans run on the server's device; pass device= to GraphServer")
        mesh = plan_kw.get("mesh")
        if mesh is not None and getattr(mesh, "devices", (None,))[0] != self.device:
            raise ValueError(f"the mesh's shard-0 device must be the server's device "
                             f"{self.device}; got {mesh!r}")
        self._graphs[name] = (store, dict(plan_kw))

    def _plan_key(self, name: str, entry: _AlgEntry) -> tuple:
        store, plan_kw = self._graphs[name]
        kw_key = repr(sorted(plan_kw.items()))
        if plan_kw.get("memory_budget") is not None:
            # streaming plans are bound to their store
            return (name, entry.key, kw_key)
        # in-core plans key on shapes so same-shape graphs share one
        # plan object (and its steps) via plan.run(other_store)
        return ("__shape__", store.n, store.m, store.p, entry.key, kw_key)

    def plan_for(self, name: str, algorithm: str, params: dict | None = None):
        """The resident plan serving ``(graph, algorithm, params)`` —
        built (and charged to the budget) on first use."""
        return self._plan_of(name, _resolve(algorithm, params or {}))

    def _plan_of(self, name: str, entry: _AlgEntry):
        store, plan_kw = self._graphs[name]
        key = self._plan_key(name, entry)
        plan = self._plans.get(key)
        if plan is None:
            plan = compile_plan(entry.shared_alg, store, device=self.device, **plan_kw)
            self._plans[key] = plan
        if (key, name) not in self._charged:
            if plan.store is store:
                nbytes = plan.resident_device_bytes
            else:
                # cross-graph reuse: this graph's binding adds its own
                # context tensors next to the original graph's
                nbytes = context_bytes(plan.bind(store).context)
            self.admission.add_resident(nbytes)
            self._charged.add((key, name))
        return plan

    # -- submission ----------------------------------------------------
    def submit(self, query: Query) -> int:
        """Price, admit (or queue/reject) one query; returns its uid."""
        if query.graph not in self._graphs:
            raise KeyError(f"graph {query.graph!r} not registered")
        entry = _resolve(query.algorithm, query.params)
        store, _ = self._graphs[query.graph]
        # plans go resident before queries price against the remainder
        self._plan_of(query.graph, entry)
        state = entry.query_alg.init_state(store)
        query._entry = entry
        query._state_bytes = tree_array_bytes(state)
        query.priced_bytes = batch_state_bytes(query._state_bytes, 1)
        query.uid = self._uid
        self._uid += 1
        query.submitted_s = time.perf_counter()
        decision = self.admission.decide(query.tenant, query.priced_bytes)
        if decision == REJECT:
            self._finish(query, "rejected", (
                f"priced footprint {query.priced_bytes} bytes can never be "
                "admitted (resident plans + query exceed the serving budget, "
                "or the query alone exceeds its tenant cap)"))
            self._stats.record_reject()
        elif decision == QUEUE and self.admission.queue_full(len(self._queue)):
            # shed instead of buffering without bound; the hint is the
            # observed median latency — roughly one in-flight batch's
            # worth of wait
            query.retry_after_s = self._stats.retry_after_hint()
            self._finish(query, "rejected", (
                f"queue full ({self.admission.max_queue} waiting); "
                f"retry after {query.retry_after_s:.3f}s"))
            self._stats.record_reject()
            self._stats.record_retry_after()
        elif decision == QUEUE:
            query.status = "queued"
            query._init_state = state
            self._stats.record_queue()
            self._queue.append(query)
        else:
            self.admission.admit(query.tenant, query.priced_bytes)
            query.status = "admitted"
            query._init_state = state
            self._stats.record_admit()
            self._admitted.append(query)
        self._stats.queue_depth = len(self._queue)
        return query.uid

    def _finish(self, q: Query, status: str, reason: str | None = None) -> None:
        """Move ``q`` to the done table with its final status."""
        q.status = status
        q.reason = reason
        q._init_state = None
        self._done[q.uid] = q

    def _promote(self) -> None:
        """Re-decide queued queries in FIFO order as capacity frees up."""
        still: list[Query] = []
        for q in self._queue:
            decision = self.admission.decide(q.tenant, q.priced_bytes)
            if decision == ADMIT:
                self.admission.admit(q.tenant, q.priced_bytes)
                q.status = "admitted"
                self._stats.record_admit()
                self._admitted.append(q)
            elif decision == REJECT:
                # capacity shrank since queueing (new resident plan)
                self._finish(q, "rejected", "serving capacity shrank while queued")
                self._stats.record_reject()
            else:
                still.append(q)
        self._queue = still
        self._stats.queue_depth = len(self._queue)

    def _withdraw(self, q: Query, pool: list[Query], admitted: bool) -> None:
        """Take a waiting query out of its pool, releasing its charged
        bytes when it had been admitted."""
        pool.remove(q)
        if admitted:
            self.admission.release(q.tenant, q.priced_bytes)

    def _expire(self) -> None:
        """Expire waiting queries whose deadline has elapsed.

        Applies to queued AND admitted queries — anything not yet
        inside a running batch.  Expired-while-admitted queries release
        their charged bytes so the headroom they held frees up."""
        now = time.perf_counter()
        for pool, admitted in ((self._queue, False), (self._admitted, True)):
            for q in [q for q in pool
                      if q.deadline_s is not None and now - q.submitted_s > q.deadline_s]:
                self._withdraw(q, pool, admitted)
                self._finish(q, "expired", f"deadline {q.deadline_s}s elapsed before execution")
                self._stats.record_deadline_exceeded()
        self._stats.queue_depth = len(self._queue)

    def cancel(self, uid: int) -> bool:
        """Withdraw a waiting query (queued or admitted); returns True
        when it was cancelled, False when it was not waiting (already
        done, rejected, or never submitted)."""
        for pool, admitted in ((self._queue, False), (self._admitted, True)):
            for q in pool:
                if q.uid == uid:
                    self._withdraw(q, pool, admitted)
                    self._finish(q, "cancelled", "cancelled by caller")
                    self._stats.record_cancel()
                    self._stats.queue_depth = len(self._queue)
                    return True
        return False

    # -- execution -----------------------------------------------------
    def step(self) -> int:
        """Form and run ONE batch; returns queries completed.

        A batch that raises is isolated, not fatal to the server: a
        multi-query batch's members are re-admitted to run **solo** (one
        poisoned query cannot sink its cohort — the others complete on
        their own), and a failing singleton is marked ``failed`` with
        the error as its ``reason``.
        """
        self._expire()
        self._promote()
        if not self._admitted:
            return 0
        head = self._admitted[0]
        entry = head._entry
        group = [q for q in self._admitted
                 if (q.graph, q._entry.key) == (head.graph, entry.key)]
        pad_reserved = 0
        if getattr(head, "_solo", False):
            # failure isolation: this query's previous batch raised —
            # run it alone so a cohort failure pinpoints the culprit
            group, bucket = [head], 1
        elif entry.batchable:
            group = group[: self.max_batch]
            bucket = bucket_size(len(group), minimum=1)
            pad_rows = bucket - len(group)
            if pad_rows:
                pad_reserved = batch_state_bytes(head._state_bytes, pad_rows)
                if not self.admission.reserve(pad_reserved):
                    # padding rows don't fit: shrink to the largest
                    # power-of-two batch (no padding needed)
                    pad_reserved = 0
                    bucket = 1 << (len(group).bit_length() - 1)
                    group = group[:bucket]
        else:
            group, bucket = group[:1], 1
        for q in group:
            self._admitted.remove(q)

        store, _ = self._graphs[head.graph]
        plan = self._plan_of(head.graph, entry)
        try:
            with obs.span("serve.batch", lane="main", graph=head.graph, alg=entry.key[0],
                          real=len(group), bucket=bucket):
                if self._faults is not None:
                    self._faults.fire("serve.query", graph=head.graph, uid=head.uid,
                                      batch=len(group))
                state = (batch_states([q._init_state for q in group], pad_to=bucket)
                         if entry.batchable else group[0]._init_state)
                res = plan.run(store=store, state=state)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            return self._fail_batch(group, e)
        finally:
            if pad_reserved:
                self.admission.unreserve(pad_reserved)
        end = time.perf_counter()

        steps = res.iterations * getattr(plan, "num_waves", 1)
        self._stats.record_batch(real=len(group), padded=bucket, steps=steps)
        for i, q in enumerate(group):
            sliced = unbatch_state(res.state, i) if entry.batchable else res.state
            q.result = plan.alg.finalize(store, sliced) if plan.alg.finalize else sliced
            q.latency_s = end - q.submitted_s
            self._finish(q, "done")
            self._stats.record_latency(q.latency_s)
            self.admission.release(q.tenant, q.priced_bytes)
        self._stats.footprint_high_water_bytes = self.admission.high_water_bytes
        obs.metrics.gauge("serve.footprint_high_water_bytes").set_max(
            self.admission.high_water_bytes)
        res.schedule_stats["serving"] = self.stats()
        self.last_schedule_stats = res.schedule_stats
        for q in group:
            q.schedule_stats = res.schedule_stats
        self._promote()
        return len(group)

    def _fail_batch(self, group: list[Query], exc: Exception) -> int:
        """Isolate one raised batch; returns queries completed (0 — the
        server stays up either way)."""
        self._stats.record_batch_failure()
        obs.instant("batch_failure", lane="resilience", error=type(exc).__name__,
                    real=len(group))
        if len(group) == 1:
            q = group[0]
            q.latency_s = time.perf_counter() - q.submitted_s
            self._finish(q, "failed", f"{type(exc).__name__}: {exc}")
            self.admission.release(q.tenant, q.priced_bytes)
            return 0
        # a cohort failed: any member might be the poison — re-admit
        # each to run solo (their bytes stay charged; they are still
        # admitted work).  A query whose solo run also raises lands in
        # the singleton branch above and is marked failed.
        for q in group:
            q._solo = True
        self._admitted[:0] = group
        return 0

    def drain(self) -> dict[int, Query]:
        """Run batches until every submitted query is done/rejected."""
        while self._admitted or self._queue:
            if self.step() == 0 and not self._admitted and self._queue:
                # _promote() either admits or rejects every queued query
                # once nothing is in flight; reaching this means the
                # accounting is inconsistent — fail loudly.  (A step
                # that completed nothing because its batch failed or
                # expired leaves nothing admitted and nothing queued.)
                raise RuntimeError(
                    f"{len(self._queue)} queued queries cannot be admitted "
                    "with no work in flight")
        return dict(self._done)

    # -- introspection -------------------------------------------------
    def result(self, uid: int) -> Query | None:
        return self._done.get(uid)

    def stats(self) -> dict:
        """The serving stats block (also injected into each batch's
        ``schedule_stats["serving"]``)."""
        return self._stats.snapshot()
