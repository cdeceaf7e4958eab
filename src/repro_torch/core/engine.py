"""Execution plans (paper §4.1, Fig. 2) — build vs execute, in-core.

Execution flow reproduced from the paper:

  read → partition into blocks → compose block-lists (P_C/P_G) →
  estimate (E) & sort → [ I_B → run kernels on all tasks → I_A ]*

* :func:`compile_plan` does everything *before* the bracket once —
  schedule composition, dense-tile materialization, algorithm
  ``prepare``, moving the store to the device — and returns a
  :class:`Plan` that owns the per-iteration step.
* :meth:`Plan.run` executes the bracketed loop: ``I_B`` and ``I_A`` run
  on the host between steps; the step runs the sparse (K_H) and dense
  (K_D) kernels back-to-back over their own slices of the work.

PyTorch runs eagerly, so a step is a Python function over the
algorithm's kernels and nothing is traced.  Steps are still shared
process-wide per ``(algorithm name, params, device type, direction)``
and :attr:`Plan.compile_count` counts the steps built.

The plan runs on ``cuda`` unless the caller asks for ``device="cpu"``;
with no card present and no device named, :func:`compile_plan` raises.
The streaming executor, the host lane, faults and checkpoints and the
device mesh are not ported yet: their arguments raise
:class:`NotImplementedError` naming the ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch

from .. import obs
from .blocks import BlockStore
from .compilecache import alg_cache_key, shared_entry
from .context import Context, HostCtx, build_context, build_host_ctx, to_device
from .direction import DirectionController, kernels_for, resolve_direction
from .functors import BlockAlgorithm
from .scheduler import Schedule, build_schedule

__all__ = ["Plan", "compile_plan", "RunResult", "resolve_device"]

#: unported compile_plan arguments → the ROADMAP item that ports them
_UNPORTED = {
    "memory_budget": "A7 (out-of-core streaming executor)",
    "rebalance_threshold": "A7 (out-of-core streaming executor)",
    "pipeline_depth": "A7 (out-of-core streaming executor)",
    "host_fraction": "A8 (heterogeneous host lane)",
    "faults": "A9 (faults, resilience and run checkpoints)",
    "checkpoint_every": "A9 (faults, resilience and run checkpoints)",
    "checkpoint_dir": "A9 (faults, resilience and run checkpoints)",
    "retry_policy": "A9 (faults, resilience and run checkpoints)",
    "mesh": "A10 (mesh composition)",
}


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` → the current CUDA device; raises when there is none.
    The port never moves to the CPU unless the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda; got {device}")
    return device


@dataclass
class RunResult:
    result: Any
    state: Any
    iterations: int
    seconds: float
    schedule_stats: dict


class _Step:
    """One built step: sparse kernel, dense kernel, then ``post``."""

    def __init__(self, alg: BlockAlgorithm, direction: str = "push") -> None:
        self.builds = 1
        obs.metrics.counter("compile.traces").inc()
        self.kernel_sparse, self.kernel_dense = kernels_for(alg, direction)
        self.post = alg.post

    def __call__(self, ctx: Context, state, it: int, run_dense: bool):
        if self.kernel_sparse is not None:
            state = self.kernel_sparse(ctx, state, it)
        if self.kernel_dense is not None and run_dense:
            state = self.kernel_dense(ctx, state, it)
        if self.post is not None:
            state = self.post(ctx, state, it)
        return state


_STEP_CACHE: dict[tuple, _Step] = {}


def _step_for(alg: BlockAlgorithm, device: torch.device, *, share: bool = True,
              direction: str = "push") -> _Step:
    return shared_entry(_STEP_CACHE, alg_cache_key(alg, device.type, direction),
                        lambda: _Step(alg, direction), share=share)


@dataclass
class _Binding:
    """Per-store inputs: the contexts and the static routing."""

    store: BlockStore
    schedule: Schedule
    context: Context
    host: HostCtx
    run_dense: bool


class Plan:
    """A reusable execution plan for one algorithm on one device.

    Produced by :func:`compile_plan`.  ``plan.run()`` executes on the
    store it was built against; ``plan.run(other_store)`` binds and runs
    another graph with the same steps.
    """

    # Non-default bindings are memoized with a small FIFO cap so a sweep
    # over many graphs doesn't pin every store's device tensors forever.
    _MAX_BINDINGS = 8

    def __init__(self, alg: BlockAlgorithm, store: BlockStore,
                 schedule: Schedule | None, *, device: torch.device,
                 num_devices: int, mode: str, tile_dim: int,
                 dense_frac: float, dense_density: float,
                 share: bool = True, direction: str | None = None) -> None:
        self.alg = alg
        self.device = device
        self.direction = resolve_direction(alg, direction)
        # None keeps the pre-direction contract: plain push, no
        # controller, no schedule_stats["direction"] block
        self._direction_requested = direction is not None
        self._sched_kw = dict(
            num_devices=num_devices, mode=mode, tile_dim=tile_dim,
            dense_frac=dense_frac, dense_density=dense_density,
        )
        self._steps = {"push": _step_for(alg, device, share=share)}
        if self.direction in ("pull", "auto"):
            self._steps["pull"] = _step_for(alg, device, share=share,
                                            direction="pull")
        self._bindings: dict[int, _Binding] = {}
        self._default = self.bind(store, schedule)

    def bind(self, store: BlockStore,
             schedule: Schedule | None = None) -> _Binding:
        """Build (and memoize) the contexts for ``store``."""
        cached = self._bindings.get(id(store))
        if (cached is not None and cached.store is store
                and (schedule is None or cached.schedule is schedule)):
            return cached
        sched = schedule or build_schedule(self.alg, store, **self._sched_kw)
        extras = self.alg.run_prepare(store, sched, None)
        binding = _Binding(
            store=store,
            schedule=sched,
            context=build_context(store, sched, self.device, extras=extras),
            host=build_host_ctx(store, sched, self.device),
            run_dense=(self.alg.kernel_dense is not None
                       and bool(sched.dense_task_mask.any())),
        )
        self._bindings.pop(id(store), None)
        self._bindings[id(store)] = binding
        if len(self._bindings) > self._MAX_BINDINGS:
            default = getattr(self, "_default", None)
            for key in list(self._bindings):
                if len(self._bindings) <= self._MAX_BINDINGS:
                    break
                if self._bindings[key] is not default:
                    del self._bindings[key]
        return binding

    @property
    def store(self) -> BlockStore:
        return self._default.store

    @property
    def schedule(self) -> Schedule:
        """The schedule is a first-class artifact — inspect it freely."""
        return self._default.schedule

    @property
    def context(self) -> Context:
        return self._default.context

    @property
    def host(self) -> HostCtx:
        return self._default.host

    @property
    def compile_count(self) -> int:
        """Steps built for this plan's algorithm: 1 for a push plan, 2
        with pull/auto.  Shared across every Plan using the same cached
        step, so a second plan or a second graph builds nothing."""
        return sum(step.builds for step in self._steps.values())

    def run(self, store: BlockStore | None = None,
            state: Any | None = None) -> RunResult:
        """Execute the iteration loop; see module docstring for the contract.

        With ``alg.after`` present, iterate while it returns True (up to
        ``max_iterations``); without it, run exactly ``max_iterations``
        steps.  ``state`` (a dict of arrays or tensors) is moved to the
        plan's device; the default is ``alg.init_state(store)``.
        """
        alg = self.alg
        b = self._default if store is None else self.bind(store)
        if state is None:
            if alg.init_state is None:
                raise ValueError(f"{alg.name}: init_state required")
            state = alg.init_state(b.store)
        state = to_device(state, self.device)
        ctrl = (DirectionController(alg, self.direction, b.store.n)
                if self._direction_requested else None)
        t0 = time.perf_counter()
        it = 0
        cont = True
        while cont and it < alg.max_iterations:
            with obs.span("iteration", lane="main", it=it, alg=alg.name):
                if alg.before is not None:
                    state = alg.before(b.host, state, it)
                step = (self._steps[ctrl.decide(state, it)]
                        if ctrl is not None else self._steps["push"])
                with obs.span("compute", lane="device", it=it):
                    state = step(b.context, state, it, b.run_dense)
                if alg.after is not None:
                    state, cont = alg.after(b.host, state, it)
            it += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        m = obs.metrics
        m.counter("engine.runs").inc()
        m.counter("engine.iterations").inc(it)
        m.histogram("engine.run_seconds").observe(dt)
        result = alg.finalize(b.store, state) if alg.finalize else state
        stats = b.schedule.stats
        if ctrl is not None:
            stats = dict(stats, direction=ctrl.stats())
        return RunResult(result=result, state=state, iterations=it,
                         seconds=dt, schedule_stats=stats)


def compile_plan(
    alg: BlockAlgorithm,
    store: BlockStore,
    schedule: Schedule | None = None,
    *,
    device: "str | torch.device | None" = None,
    num_devices: int = 1,
    mode: str = "hybrid",
    tile_dim: int = 512,
    dense_frac: float = 0.5,
    dense_density: float = 0.005,
    share: bool = True,
    direction: str | None = None,
    memory_budget=None,
    rebalance_threshold=None,
    pipeline_depth=None,
    mesh=None,
    host_fraction=None,
    faults=None,
    checkpoint_every=None,
    checkpoint_dir=None,
    retry_policy=None,
) -> Plan:
    """Build: schedule, dense tiles, prepare, contexts on ``device``.

    ``device`` defaults to the current CUDA device and raises when no
    card is present; ``device="cpu"`` runs every kernel's plain version.
    ``direction`` selects the kernel direction for algorithms that
    declare the ``metadata["direction"]`` capability
    (:mod:`repro_torch.core.direction`): ``"push"`` / ``"pull"`` pin one
    variant, ``"auto"`` decides per iteration from the frontier density
    behind a hysteresis band; every decision is recorded in
    ``schedule_stats["direction"]``.  ``None`` keeps the plain push step
    with no controller.  ``share=False`` opts out of the process-wide
    step cache (for ad-hoc algorithms that reuse a registered name with
    different kernels).
    """
    given = dict(memory_budget=memory_budget,
                 rebalance_threshold=rebalance_threshold,
                 pipeline_depth=pipeline_depth, mesh=mesh,
                 host_fraction=host_fraction, faults=faults,
                 checkpoint_every=checkpoint_every,
                 checkpoint_dir=checkpoint_dir, retry_policy=retry_policy)
    for name, value in given.items():
        if value is not None:
            raise NotImplementedError(
                f"compile_plan({name}=...) is not ported yet: ROADMAP {_UNPORTED[name]}")
    return Plan(
        alg, store, schedule,
        device=resolve_device(device), num_devices=num_devices, mode=mode,
        tile_dim=tile_dim, dense_frac=dense_frac,
        dense_density=dense_density, share=share, direction=direction,
    )
