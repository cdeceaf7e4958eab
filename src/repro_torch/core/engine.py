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
``memory_budget`` switches to the out-of-core streaming executor
(:class:`~repro_torch.core.stream.StreamingPlan`), whose
``host_fraction`` co-schedules the host CPU as a compute lane.  Both
executors take the fault-tolerant runtime: ``faults`` (seeded
injection, :mod:`repro_torch.core.faults`), ``retry_policy`` (the
recovery ladder, :mod:`repro_torch.core.resilience`) and
``checkpoint_every``/``checkpoint_dir`` with :meth:`Plan.resume`
(:mod:`repro_torch.checkpoint`).  ``mesh`` (a
:class:`~repro_torch.core.distributed.DeviceMesh`, streaming only) runs
each wave's tasks sharded over the mesh's devices from one controller
(:mod:`repro_torch.core.distributed`).

:func:`run` compiles and executes in one call; :class:`Engine` is the
reference's deprecated shim over :func:`compile_plan`.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from .. import obs
from .blocks import BlockStore
from .compilecache import alg_cache_key, shared_entry
from .context import Context, HostCtx, build_context, build_host_ctx, to_device
from .direction import DirectionController, kernels_for, resolve_direction
from .distributed import DeviceMesh
from .faults import FaultPlan
from .functors import BlockAlgorithm
from .knobs import env_str
from .membudget import tree_array_bytes, tree_map
from .resilience import ResilienceStats, RetryPolicy, classify
from .scheduler import Schedule, build_schedule

if TYPE_CHECKING:  # pragma: no cover — import cycle guard, typing only
    from .stream import StreamingPlan

__all__ = ["Plan", "compile_plan", "RunResult", "Engine", "run", "resolve_device",
           "resilience_config", "batch_states", "unbatch_state", "context_bytes"]


def resilience_config(faults, retry_policy, checkpoint_every, checkpoint_dir):
    """Validate the fault-tolerance arguments shared by both executors:
    ``(fault plan or None, retry policy, checkpoint period (0 = off),
    checkpoint directory)``.  ``REPRO_FAULTS`` is the environment's
    spelling of ``faults``; an explicit argument wins.  A directory
    alone means "checkpoint every iteration"."""
    plan = FaultPlan.parse(faults if faults is not None else env_str("REPRO_FAULTS"))
    if retry_policy is not None and not isinstance(retry_policy, RetryPolicy):
        raise TypeError(
            f"retry_policy must be a repro_torch.core.resilience.RetryPolicy; "
            f"got {type(retry_policy).__name__}")
    if checkpoint_every is not None and int(checkpoint_every) < 1:
        raise ValueError(f"checkpoint_every must be >= 1; got {checkpoint_every!r}")
    if checkpoint_every is not None and checkpoint_dir is None:
        raise ValueError(
            "checkpoint_every requires checkpoint_dir (where the "
            "per-iteration snapshots persist)")
    every = int(checkpoint_every) if checkpoint_every else (1 if checkpoint_dir else 0)
    return plan, retry_policy or RetryPolicy(), every, checkpoint_dir


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


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))   # copies; a 0-d leaf stays 0-d


# ----------------------------------------------------------------------
# Batched-state entry point.  Algorithms that declare
# ``metadata["batch"] == "query"`` accept a state with a leading query
# axis: their kernels run every query's state against the one shared
# graph context in the same launches.  These helpers build and take
# apart that axis; Plan.run(state=...) and StreamingPlan.run(state=...)
# execute the batched state unchanged.
def batch_states(states, *, pad_to: int | None = None):
    """Stack per-query states (dicts of arrays or tensors, one structure
    and per-leaf shape for all) into one batched state of tensors.

    With ``pad_to`` (a bucket from
    :func:`repro_torch.core.membudget.bucket_size`) the batch is padded
    by repeating the last query's state; padded rows compute real
    results that callers discard.
    """
    states = list(states)
    if not states:
        raise ValueError("batch_states needs at least one state")
    if pad_to is not None:
        if pad_to < len(states):
            raise ValueError(
                f"pad_to={pad_to} is smaller than the batch of {len(states)}")
        states = states + [states[-1]] * (pad_to - len(states))
    return tree_map(lambda *leaves: torch.stack([_as_tensor(x) for x in leaves]),
                     *states)


def unbatch_state(state, index: int):
    """Query ``index``'s row of a batched state."""
    return tree_map(lambda leaf: leaf[index], state)


def context_bytes(ctx: Context) -> int:
    """The admission price of a context: the bytes of its tensors, less
    the tiles' extents (``tile_rows``/``tile_cols``, 8 bytes a dense
    tile), which the JAX reference's contexts do not hold.  The streamed
    plan leaves its per-stripe width table out alike, so both packages
    price one store to the byte and admit alike."""
    return tree_array_bytes(replace(ctx, tile_rows=None, tile_cols=None))


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
                 share: bool = True, direction: str | None = None,
                 faults: "str | FaultPlan | None" = None,
                 checkpoint_every: int | None = None,
                 checkpoint_dir: str | None = None,
                 retry_policy: RetryPolicy | None = None) -> None:
        # the in-core step is the "wave.compute" seam; an iteration maps
        # its start state to the next state, so a failed attempt is
        # retried from the same state, and checkpoints land on
        # iteration boundaries
        (self._faults, self._policy, self._ckpt_every,
         self._ckpt_dir) = resilience_config(faults, retry_policy,
                                             checkpoint_every, checkpoint_dir)
        self._resil = ResilienceStats()
        self._injected_pub = 0
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
        # the in-core plan has one context, so prepare keeps its unpadded
        # form (no staging plan); the scratch declaration is the
        # streaming executor's budget input, not a kernel input
        extras = self.alg.run_prepare(store, sched, None)
        extras.pop("__workspace_bytes__", None)
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

    @property
    def resident_device_bytes(self) -> int:
        """Device bytes of holding this plan hot, state excluded: the
        default binding's context as :func:`context_bytes` prices it
        (graph tensors, tiles, prepared extras).  The serving admission
        controller's price for a resident in-core plan; query state is
        priced per batch."""
        return context_bytes(self._default.context)

    def run(self, store: BlockStore | None = None,
            state: Any | None = None, *,
            _start_it: int = 0, _start_cont: bool = True,
            _ctrl_restore: dict | None = None) -> RunResult:
        """Execute the iteration loop; see module docstring for the contract.

        With ``alg.after`` present, iterate while it returns True (up to
        ``max_iterations``); without it, run exactly ``max_iterations``
        steps.  ``state`` (a dict of arrays or tensors) is moved to the
        plan's device; the default is ``alg.init_state(store)``.  The
        underscored keywords are :meth:`resume`'s continuation protocol,
        not public surface.
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
        if ctrl is not None and _ctrl_restore is not None:
            restore_controller(ctrl, _ctrl_restore)
        t0 = time.perf_counter()
        it = int(_start_it)
        cont = bool(_start_cont)
        while cont and it < alg.max_iterations:
            with obs.span("iteration", lane="main", it=it, alg=alg.name):
                if alg.before is not None:
                    state = alg.before(b.host, state, it)
                step = (self._steps[ctrl.decide(state, it)]
                        if ctrl is not None else self._steps["push"])
                state = self._step_resilient(step, b, state, it)
                if alg.after is not None:
                    state, cont = alg.after(b.host, state, it)
            it += 1
            if self._ckpt_every and (it % self._ckpt_every == 0 or not cont):
                self._save_checkpoint(state, it, cont, ctrl)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        m = obs.metrics
        m.counter("engine.runs").inc()
        m.counter("engine.iterations").inc(it)
        m.histogram("engine.run_seconds").observe(dt)
        if self._faults is not None:
            new = self._faults.injected - self._injected_pub
            if new > 0:
                m.counter("stream.fault_injected").inc(new)
                self._injected_pub = self._faults.injected
        result = alg.finalize(b.store, state) if alg.finalize else state
        stats = b.schedule.stats
        if ctrl is not None:
            stats = dict(stats, direction=ctrl.stats())
        # only runs that opted into fault tolerance (or actually
        # recovered) grow the stats dict
        if self._faults is not None or self._ckpt_every or self._resil.fired:
            stats = dict(stats, resilience=self._resil.snapshot(self._faults))
        return RunResult(result=result, state=state, iterations=it,
                         seconds=dt, schedule_stats=stats)

    def _step_resilient(self, step: _Step, b: _Binding, state, it: int):
        """One step with the ``wave.compute`` fault seam and bounded
        retry.  The step maps the iteration-start state to the next
        state without changing its input, so a failed attempt is
        discarded and retried from the same ``state``.
        ``KeyboardInterrupt``/``SystemExit`` always propagate."""
        faults, policy, res = self._faults, self._policy, self._resil
        attempts = 0
        while True:
            try:
                with obs.span("compute", lane="device", it=it):
                    out = step(b.context, state, it, b.run_dense)
                    if faults is not None:
                        out = faults.fire("wave.compute", out, it=it)
                return out
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                kind = classify(e)
                res.detected += 1
                attempts += 1
                obs.instant("failure", lane="resilience", it=it, kind=kind,
                            error=type(e).__name__)
                if attempts > policy.max_retries:
                    res.record("exhausted", it=it, kind=kind, attempts=attempts)
                    raise
                res.record("retry", it=it, kind=kind, attempts=attempts)
                res.retries += 1
                obs.metrics.counter("stream.fault_retries").inc()
                obs.instant("recovery", lane="resilience", it=it, action="retry")

    def _save_checkpoint(self, state, it: int, cont: bool, ctrl) -> None:
        save_run_checkpoint(self._ckpt_dir, self._resil, state, it, cont, ctrl)

    def resume(self, ckpt_dir: str | None = None, *,
               step: int | None = None) -> RunResult:
        """Continue from the newest (or ``step``'s) snapshot in
        ``ckpt_dir`` (defaults to this plan's ``checkpoint_dir``).

        Bit-identical for integer/boolean attributes: the loop restarts
        at the stored iteration boundary with the stored continue flag
        and direction-controller history.  ``RunResult.iterations``
        stays the absolute iteration count."""
        snap = load_run_checkpoint(self.alg, self.store,
                                   ckpt_dir if ckpt_dir is not None else self._ckpt_dir, step)
        return self.run(state=snap.state, _start_it=snap.it,
                        _start_cont=snap.cont, _ctrl_restore=snap.ctrl)


def restore_controller(ctrl: DirectionController, saved: dict) -> None:
    """Put a snapshot's latch state and decision history back into a
    fresh controller: its hysteresis depends on both."""
    ctrl.current = str(saved["current"])
    ctrl.switches = int(saved["switches"])
    ctrl.decisions = list(saved["decisions"])
    ctrl.densities = list(saved["densities"])


def save_run_checkpoint(ckpt_dir: str, res: ResilienceStats, state, it: int,
                        cont: bool, ctrl) -> None:
    """Atomically persist ``(state, it, cont, controller state)`` after
    iteration ``it - 1`` (:func:`repro_torch.checkpoint.save_runstate`)."""
    from ..checkpoint.runstate import save_runstate

    with obs.span("checkpoint", lane="resilience", it=it):
        save_runstate(ckpt_dir, state, it=it, cont=cont, ctrl=ctrl)
    res.checkpoints += 1
    obs.metrics.counter("stream.checkpoints").inc()


def load_run_checkpoint(alg: BlockAlgorithm, store: BlockStore, ckpt_dir: str | None,
                        step: int | None):
    """The snapshot a ``resume()`` continues from, in ``alg.init_state``'s
    structure and dtypes (host arrays; ``run`` moves them)."""
    from ..checkpoint.runstate import load_runstate

    if ckpt_dir is None:
        raise ValueError(
            "resume() needs a checkpoint directory: pass ckpt_dir or "
            "build the plan with checkpoint_dir=...")
    if alg.init_state is None:
        raise ValueError(f"{alg.name}: init_state required")
    return load_runstate(ckpt_dir, alg.init_state(store), step=step)


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
    rebalance_threshold="auto",
    pipeline_depth=None,
    mesh=None,
    host_fraction="auto",
    faults=None,
    checkpoint_every=None,
    checkpoint_dir=None,
    retry_policy=None,
) -> "Plan | StreamingPlan":
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

    ``memory_budget`` (bytes, or a string like ``"64MB"``) switches to
    the out-of-core streaming executor: the result is a
    :class:`~repro_torch.core.stream.StreamingPlan` whose ``run`` streams
    budget-sized waves of tasks to the device instead of shipping the
    whole edge set up front; the schedule is built budget-aware.
    ``rebalance_threshold`` (``"auto"``, a float, or ``None`` for off)
    and ``pipeline_depth`` (waves the staging worker assembles ahead,
    default 2; ``0`` stages synchronously) apply to it only.

    ``host_fraction`` (streaming only) co-schedules the host CPU as a
    compute resource: each wave splits into a device partition and a
    host partition, whose tasks run the algorithm's sparse kernel on CPU
    tensors in a ``repro-host`` thread pool while the card computes its
    waves; their partials fold through ``metadata["combine"]``, so
    integer/bool results equal a device-only run.  ``"auto"`` (the
    default) starts device-only and peels the light tail of each wave
    once calibration shows the host can hide behind the device; a float
    in ``[0, 1]`` pins the host share; ``None`` disables the lane.
    ``schedule_stats["hetero"]`` reports the split and the makespans.

    ``faults`` / ``retry_policy`` / ``checkpoint_every`` /
    ``checkpoint_dir`` (both executors) opt into the fault-tolerant
    runtime: ``faults`` is a seeded injection spec
    (``"site:action[:trigger]"``, ``;``-joined, see
    :mod:`repro_torch.core.faults`; defaults to ``REPRO_FAULTS``),
    ``retry_policy`` a :class:`~repro_torch.core.resilience.RetryPolicy`
    bounding the retry / shrink / demote ladder, and ``checkpoint_dir``
    persists atomic per-iteration run snapshots every
    ``checkpoint_every`` iterations (default every one) that
    ``plan.resume()`` continues bit-identically for integer/bool
    attributes.  Recoveries surface in ``schedule_stats["resilience"]``.

    ``mesh`` (streaming only) is a
    :class:`~repro_torch.core.distributed.DeviceMesh`: the budget is per
    shard, waves pack to ``mesh.size × budget``, each shard stages and
    computes its share of every wave on its own device, and the partials
    fold with ``metadata["combine"]`` on shard 0's device, which is the
    plan's device (``device`` may be omitted, or must name it).
    """
    if rebalance_threshold not in (None, "auto") and memory_budget is None:
        raise ValueError(
            "rebalance_threshold only applies to the streaming executor; "
            "pass memory_budget=... as well (the in-core Plan has no waves "
            "to rebalance)")
    if pipeline_depth is not None and memory_budget is None:
        raise ValueError(
            "pipeline_depth only applies to the streaming executor; pass "
            "memory_budget=... as well (the in-core Plan stages no waves)")
    if host_fraction not in (None, "auto") and memory_budget is None:
        raise ValueError(
            "host_fraction only applies to the streaming executor; pass "
            "memory_budget=... as well (the in-core Plan has no waves to "
            "split across host and device)")
    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a repro_torch.core.distributed.DeviceMesh; "
                            f"got {type(mesh).__name__}")
        if memory_budget is None:
            raise ValueError(
                "mesh= composes the *streaming* executor with a device mesh; pass "
                "memory_budget=... as well (for whole-graph resident mesh execution "
                "use repro_torch.core.distributed.DistributedEngine)")
        if device is not None and resolve_device(device) != mesh.devices[0]:
            raise ValueError(f"device={device} is not the mesh's shard-0 device "
                             f"{mesh.devices[0]}; a mesh plan runs on its shard-0 device")
        device = mesh.devices[0]
    resilience = dict(faults=faults, checkpoint_every=checkpoint_every,
                      checkpoint_dir=checkpoint_dir, retry_policy=retry_policy)
    if memory_budget is not None:
        from .membudget import PIPELINE_DEPTH
        from .stream import StreamingPlan

        return StreamingPlan(
            alg, store, schedule, memory_budget=memory_budget,
            device=resolve_device(device), num_devices=num_devices, mode=mode,
            tile_dim=tile_dim, dense_frac=dense_frac, dense_density=dense_density,
            share=share, direction=direction, rebalance_threshold=rebalance_threshold,
            pipeline_depth=PIPELINE_DEPTH if pipeline_depth is None else pipeline_depth,
            host_fraction=host_fraction, mesh=mesh, **resilience)
    return Plan(
        alg, store, schedule,
        device=resolve_device(device), num_devices=num_devices, mode=mode,
        tile_dim=tile_dim, dense_frac=dense_frac,
        dense_density=dense_density, share=share, direction=direction,
        **resilience)


# ----------------------------------------------------------------------
# Legacy shim
_NO_BACKEND_SWITCH = object()


class Engine:
    """Deprecated: use :func:`compile_plan` → :meth:`Plan.run`.

    Takes the reference's arguments with ``device=`` in place of
    ``backend=``/``use_pallas=``: the port picks each kernel by the
    device of its tensors and has no backend switch, so either of those
    raises ``TypeError``.
    """

    def __init__(
        self,
        alg: BlockAlgorithm,
        store: BlockStore,
        schedule: Schedule | None = None,
        *,
        num_devices: int = 1,
        mode: str = "hybrid",
        tile_dim: int = 512,
        dense_frac: float = 0.5,
        dense_density: float = 0.005,
        device: "str | torch.device | None" = None,
        backend: Any = _NO_BACKEND_SWITCH,
        use_pallas: Any = _NO_BACKEND_SWITCH,
    ) -> None:
        if backend is not _NO_BACKEND_SWITCH or use_pallas is not _NO_BACKEND_SWITCH:
            raise TypeError(
                "Engine takes no backend= or use_pallas=: the port has no backend switch; "
                "it launches each kernel on the device of its tensors, so pass device= "
                "(the current CUDA device by default, or \"cpu\") instead")
        warnings.warn("Engine is deprecated; use compile_plan(alg, store, ...).run()",
                      DeprecationWarning, stacklevel=2)
        self.plan = compile_plan(
            alg, store, schedule, device=device, num_devices=num_devices, mode=mode,
            tile_dim=tile_dim, dense_frac=dense_frac, dense_density=dense_density)
        self.alg = alg
        self.store = store

    @property
    def schedule(self) -> Schedule:
        return self.plan.schedule

    def run(self, state: Any | None = None) -> RunResult:
        return self.plan.run(state=state)


def run(alg: BlockAlgorithm, store: BlockStore, **kw) -> RunResult:
    """One-shot convenience: compile a plan and execute it."""
    return compile_plan(alg, store, **kw).run()
