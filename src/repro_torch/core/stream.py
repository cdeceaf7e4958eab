"""Out-of-core streaming executor: memory-budgeted, pipelined waves.

This makes any :class:`~repro_torch.core.engine.Plan`-compatible
algorithm runnable under an explicit device-memory budget — the paper's
headline regime ("graphs that fit host DRAM but not device memory",
§4.3/§4.4).  Five parts, as in the reference package:

1. **Footprint model** (:mod:`repro_torch.core.membudget`) prices each
   schedule task's COO slice, dense tiles, conformal CSR row slices
   (``metadata["csr"] == "slice"``) and kernel workspace in bytes; the
   schedule itself is built budget-aware.
2. **Wave builder** packs the LPT-ordered tasks into budget-sized
   *waves*; every wave's slab is padded to a power-of-two bucket ladder,
   so a handful of slab shapes (and of pooled host buffers) serves every
   wave.
3. **Three-stage host→device pipeline**: after a one-time *planning
   pass* (assemble every wave once: verify bytes against the budget,
   split overflows, hoist wave-invariant extras, cache each wave's
   ``prepare`` outputs), each iteration runs

   * **stage 1 — background assembly** (:class:`_StagePipeline`, a
     worker thread behind a bounded queue of depth ``pipeline_depth``):
     numpy gathers of wave ``k+2``'s slab into pooled host buffers;
   * **stage 2 — host→device copy** on a copy ``torch.cuda.Stream`` of
     its own, from pinned buffers with ``non_blocking=True``: an event
     recorded on the copy stream is what the compute stream waits on,
     and what gates a buffer's return to the pool;
   * **stage 3 — compute**: the wave step, folding partials.

   The first executed iteration runs synchronously to calibrate
   per-phase times (wave times from CUDA events on the card); every
   later iteration overlaps.
4. **Staging arena** (:class:`_HostArena`): one pool of pinned buffers
   per (shape, dtype).  A buffer re-enters the pool only once the copy
   that read it has landed (``event.query()``); handing it back earlier
   would let the worker's next gather overwrite bytes still in flight.
5. **Partial-result combination**: each wave's kernels run against the
   *iteration-start* state and their per-leaf updates fold with the
   algorithm's ``metadata["combine"]`` op (``add``/``min``/``max``), so
   streamed results equal the in-core step: exactly for integer/bool
   attributes, up to float summation order otherwise.  ``post`` and the
   host hooks run once per iteration on the combined state, against a
   *resident* context that holds only vertex-level tensors.

Device memory: the resident tensors plus at most two staged slabs
(current and next), each ≤ the budget.  Before the next slab is
allocated the host waits for the wave before the current one to finish,
so the caching allocator can hand its memory out again.

A wave's tile kernels read only the block rectangle of each tile: the
rectangles' extents are computed on the device from the staged tile
origins and a resident per-stripe width table, so the staged bytes stay
those of the reference's footprint model.

Heterogeneous co-scheduling — ``host_fraction``
-----------------------------------------------
The host CPU is a compute resource, not only a staging engine: each
wave splits into a *device partition* (the streamed pipeline above)
and a *host partition* — the lightest/sparsest tasks peeled off by
:func:`repro_torch.core.membudget.peel_host_tasks` into host execution
units that run the algorithm's sparse kernel on CPU tensors
(:class:`_HostLane`, a ``concurrent.futures`` pool of ``repro-host``
threads) while the card computes its waves.  The kernels' wrappers
dispatch the units' CPU tensors to their plain versions
(:data:`repro_torch.kernels.ref.HOST_EXECUTABLE`).  Host tasks are
never copied to the card, so they do not touch the memory budget;
their partials go to the card once per iteration and fold through the
same ``metadata["combine"]`` contract as device waves, so integer/bool
results equal a device-only run.  ``host_fraction`` is ``"auto"`` by
default — zero split until the calibration pass measures device waves
above a noise floor (``REPRO_HETERO_NOISE_FLOOR_S``, 10 ms), then a
hide-behind-the-device split with a probe-measured host rate and
hysteresis — or a fixed float in [0, 1]; ``None`` disables the lane.
``schedule_stats["hetero"]`` carries the split, the host/device task
counts and the per-resource makespans.

Fault tolerance — ``faults``, ``retry_policy``, ``checkpoint_*``
---------------------------------------------------------------
Seeded fault injection (:mod:`repro_torch.core.faults`) fires at the
seams ``stage.assemble``, ``stage.device_put``, ``wave.compute`` and
``host.task``.  A failed iteration re-runs from its start state under
the recovery ladder of :mod:`repro_torch.core.resilience`: a plain
retry; on an OOM a re-pack under a shrunk effective budget, then the
offending wave demoted to the host lane; on a dead staging worker,
synchronous assembly; on repeated host failures, device-only.  Before
a retry every in-flight resource is quiesced: the staging worker
stopped, the host futures waited out, both streams synchronised, the
pinned buffers returned only after their copies landed, and after a
real ``torch.cuda.OutOfMemoryError`` the allocator's cache emptied.
``checkpoint_dir`` writes a run snapshot at iteration boundaries that
:meth:`StreamingPlan.resume` continues.  The device mesh
(``mesh.collective``) waits for ROADMAP A10.

Entry point: ``compile_plan(alg, store, memory_budget=...)`` returns a
:class:`StreamingPlan` instead of a :class:`~repro_torch.core.engine.Plan`.
"""
from __future__ import annotations

import concurrent.futures
import os
import queue
import threading
import time
from dataclasses import dataclass, replace as dc_replace
from typing import Any

import numpy as np
import torch

from .. import obs
from .blocks import BlockStore, _to_int32, segment_index
from .compilecache import alg_cache_key, shared_entry
from .context import Context, build_host_ctx, to_device, with_arrays
from .direction import (
    DirectionController, kernels_for, resolve_direction, workspace_kernels,
)
from .faults import FaultPlan
from .functors import BlockAlgorithm
from .graph import csr_prefix
from .knobs import env_float
from .membudget import (
    HOST_RATIO_DEFAULT, MemoryBudget, PIPELINE_DEPTH, Wave, arena_model_bytes,
    bucket_size, build_waves, hetero_split_diverged, peel_host_tasks, repack_waves,
    resident_bytes, split_wave, task_footprints, tree_array_bytes,
    tree_leaves as _leaves, tree_map,
)
from .resilience import HostTaskError, ResilienceStats, RetryPolicy, WorkerDeath, classify
from .scheduler import Schedule, build_schedule
from .engine import (
    RunResult, load_run_checkpoint, reject_unported, resilience_config,
    restore_controller, save_run_checkpoint,
)

__all__ = ["StreamingPlan", "compile_streaming_plan", "PHASES"]

#: Per-wave pipeline phases, in execution order — also the
#: ``stream.phase_seconds.<phase>`` metric-name suffixes.  ``collective``
#: stays 0 until the mesh (ROADMAP A10) is ported.
PHASES = ("assemble", "prepare", "device_put", "compute", "collective",
          "host_compute")

_COMBINE_KINDS = ("add", "min", "max")
_CSR_MODES = ("resident", "slice", "none")

# Auto-rebalancing: fire when the observed wave-compute skew (max/mean)
# exceeds the skew the schedule's estimates predicted by _REBALANCE_HI;
# re-arm below _REBALANCE_LO.  Below the noise floor the trigger stands
# down, so small runs keep reproducible staged-byte accounting.
_REBALANCE_HI = 2.0
_REBALANCE_LO = 1.5
_REBALANCE_NOISE_FLOOR_S = 10e-3



def _hetero_noise_floor_s() -> float:
    """Below this mean device-wave time the ``"auto"`` host split stays
    at zero: dispatch jitter dominates, so peeling would be decided by
    noise.  ``REPRO_HETERO_NOISE_FLOOR_S`` overrides."""
    return env_float("REPRO_HETERO_NOISE_FLOOR_S", _REBALANCE_NOISE_FLOOR_S)


def _hetero_host_ratio_default() -> float:
    """Assumed host-vs-device slowdown before the host lane has been
    measured; ``REPRO_HETERO_HOST_RATIO`` overrides."""
    return env_float("REPRO_HETERO_HOST_RATIO", HOST_RATIO_DEFAULT)


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.bool_): torch.bool, np.dtype(np.float32): torch.float32}


def _combine_spec(alg: BlockAlgorithm):
    """metadata['combine'] → leaf-name → kind (or None when undeclared)."""
    c = alg.metadata.get("combine")
    if isinstance(c, str):
        return lambda key: c
    if isinstance(c, dict):
        return lambda key: c.get(key)
    return lambda key: None


def _combine_leaf(kind: str | None, key: str, acc, s0, new):
    if kind == "add":
        return acc + (new - s0)
    if kind == "min":
        return torch.minimum(acc, new)
    if kind == "max":
        return torch.maximum(acc, new)
    raise ValueError(
        f"state leaf {key!r} is modified by the kernels but declares no "
        f"combine kind in metadata['combine'] (one of {_COMBINE_KINDS}); "
        f"streaming cannot fold its per-wave partial results")


class _StreamStep:
    """The per-wave step: kernels from iteration-start state, partials
    folded into the running accumulator via the combine spec.

    A kernel that returns ``dict(state, acc=...)`` leaves the other
    values as the *same* tensor objects, which is the contract "this
    wave did not touch that attribute": those leaves pass through."""

    def __init__(self, alg: BlockAlgorithm, direction: str = "push") -> None:
        self.builds = 1
        obs.metrics.counter("compile.traces").inc()
        self.name = alg.name
        self.spec = _combine_spec(alg)
        self.kernel_sparse, self.kernel_dense = kernels_for(alg, direction)

    def __call__(self, ctx: Context, state0: dict, acc: dict, it: int,
                 run_dense: bool) -> dict:
        if not isinstance(state0, dict):
            raise TypeError(f"{self.name}: streaming requires a dict state")
        new = state0
        if self.kernel_sparse is not None:
            new = self.kernel_sparse(ctx, new, it)
        if self.kernel_dense is not None and run_dense:
            new = self.kernel_dense(ctx, new, it)
        added = set(new) - set(state0)
        if added:
            raise ValueError(
                f"{self.name}: kernels added state leaves {sorted(added)}; "
                f"streaming requires kernels to write only leaves present in "
                f"init_state (declare scratch attributes there)")
        return {key: acc[key] if new[key] is state0[key]
                else _combine_leaf(self.spec(key), key, acc[key], state0[key], new[key])
                for key in state0}


_STREAM_STEP_CACHE: dict[tuple, _StreamStep] = {}


def _stream_step_for(alg: BlockAlgorithm, device: torch.device, *,
                     share: bool = True, direction: str = "push") -> _StreamStep:
    return shared_entry(_STREAM_STEP_CACHE, alg_cache_key(alg, device.type, direction),
                        lambda: _StreamStep(alg, direction), share=share)


# ----------------------------------------------------------------------
def _is_array_leaf(leaf: Any) -> bool:
    return isinstance(leaf, (np.ndarray, torch.Tensor))


def _to_host(tree: Any) -> Any:
    """``tree`` with every tensor leaf as a numpy array."""
    return tree_map(lambda l: l.cpu().numpy() if isinstance(l, torch.Tensor) else l, tree)


def _trees_equal(a: Any, b: Any) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b)
                and all(_trees_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_trees_equal(x, y) for x, y in zip(a, b)))
    if _is_array_leaf(a) or _is_array_leaf(b):
        return (_is_array_leaf(a) and _is_array_leaf(b)
                and np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(np.asarray(a), np.asarray(b)))
    return a == b


def _gather(source: np.ndarray, idx: np.ndarray, out: np.ndarray) -> None:
    """``out[:k] = source[idx]`` without a temporary, ``out[k:] = 0``."""
    k = idx.shape[0]
    if k:
        np.take(source, idx, axis=0, out=out[:k], mode="clip")
    out[k:] = 0


def _spread_padding(out: np.ndarray, k: int, n: int) -> None:
    """``out[k:] = 0, 1, ..., n - 1, 0, 1, ...``.  A slab's padding arcs
    are masked out on every path, yet the scatters still visit them:
    as self-loops spread over the vertices they offer their neutral
    values (``INT32_MAX`` to a min, 0 to a sum) to many addresses, where
    padding with zeros queues every one on vertex 0."""
    pad = out[k:]
    step = min(n, pad.size)
    if step:
        base = np.arange(step, dtype=out.dtype)
        for s in range(0, pad.size, step):
            pad[s:s + step] = base[:pad.size - s]


_ABSENT = object()


# ----------------------------------------------------------------------
class _HostArena:
    """Pooled host staging buffers, one free-list per (shape, dtype).

    Every wave slab is padded to the power-of-two bucket ladder, so a
    handful of buffer shapes serves the whole plan.  For a plan on the
    card the buffers are pinned (page-locked) tensors, allocated once
    per buffer and reused, handed out as their numpy views so that the
    worker gathers straight into pinned memory.  A taken buffer's
    contents are undefined: the assembler writes every element.
    Thread-safe (the background worker takes while the main loop
    gives)."""

    def __init__(self, pin: bool) -> None:
        self._pin = pin
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._lock = threading.Lock()
        self.bytes = 0          # high-water: total bytes ever pooled
        self.reuses = 0

    def take(self, shape, dtype) -> np.ndarray:
        shape = (int(shape),) if np.isscalar(shape) else tuple(int(s) for s in shape)
        dtype = np.dtype(dtype)
        key = (shape, dtype.str)
        with self._lock:
            pool = self._free.get(key)
            buf = pool.pop() if pool else None
            if buf is not None:
                self.reuses += 1
                return buf
        if self._pin:
            buf = torch.empty(shape, dtype=_TORCH_DTYPES[dtype], pin_memory=True).numpy()
        else:
            buf = np.empty(shape, dtype)
        with self._lock:
            self.bytes += buf.nbytes
        return buf

    def give(self, *arrays: np.ndarray) -> None:
        with self._lock:
            for a in arrays:
                if a is not None:
                    self._free.setdefault((tuple(a.shape), a.dtype.str), []).append(a)


class _StagePipeline:
    """Stage 1: a persistent background worker that assembles wave slabs
    ahead of the compute loop, behind a bounded queue.

    With depth ``d`` the worker runs at most ``d`` waves ahead.  It lives
    across iterations: the main loop *requests* each iteration's wave
    epoch, and requests the next one as soon as the current epoch's last
    slab is drained.  ``assemble_s`` is the worker's busy time,
    ``stall_s`` the main loop's time blocked on the queue.  The worker
    only gathers numpy arrays; it never touches the card.  If it dies,
    :meth:`get` raises :class:`~repro_torch.core.resilience.WorkerDeath`
    carrying its exception, and the retry ladder fails over to
    synchronous assembly."""

    def __init__(self, plan: "StreamingPlan", depth: int) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._cmd: queue.Queue = queue.Queue()
        self.assemble_s = 0.0
        self.stall_s = 0.0
        self.dead = False
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._work, args=(plan,),
                                   name="repro-staging", daemon=True)
        self._t.start()

    def _work(self, plan: "StreamingPlan") -> None:
        try:
            while True:
                indices = self._cmd.get()
                if indices is None:
                    return
                for w in indices:
                    t0 = time.perf_counter()
                    slab = plan._assemble_runtime(plan._slabs[w], wave=w)
                    self.assemble_s += time.perf_counter() - t0
                    self._q.put(slab)
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
            self._q.put(None)

    def request(self, indices) -> None:
        """Enqueue one epoch (an iteration's wave order) for assembly."""
        self._cmd.put(list(indices))

    def get(self) -> "_WaveSlab":
        t0 = time.perf_counter()
        slab = self._q.get()
        self.stall_s += time.perf_counter() - t0
        if slab is None:
            self.dead = True
            raise WorkerDeath(self._err)
        return slab

    def close(self, arena: _HostArena) -> None:
        """Stop the worker; speculatively assembled slabs hand their
        buffers straight back to the arena (they were never staged).
        Keeps draining while the worker finishes its in-flight epoch,
        then joins the thread."""
        self._cmd.put(None)
        while self._t.is_alive() or not self._q.empty():
            try:
                slab = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if slab is not None:
                arena.give(*slab.arena_arrays)
        self._t.join(timeout=5.0)


# ----------------------------------------------------------------------
def _cpu_tensor(name: str, a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor (shared memory), integers as int32
    like the card's copy of the store."""
    a = np.ascontiguousarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = _to_int32(name, a)
    return torch.from_numpy(a)


def _host_value(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class _HostLane:
    """The host-CPU compute lane of heterogeneous co-scheduling.

    Each execution *unit* is one wave's peeled ``host_task_ids``
    (:func:`repro_torch.core.membudget.peel_host_tasks`).  A unit's
    context is built once — the unit's COO slice gathered from the host
    store, the global CSR views shared across every unit, and the
    algorithm's ``prepare`` outputs for the unit's restricted
    sub-schedule — with every tensor on the CPU, and the sparse kernel
    runs on them in a ``concurrent.futures`` pool of ``repro-host``
    threads while the card streams its own waves.  Nothing here is ever
    copied to the card but the folded partials: host units never touch
    the memory budget.

    Peeled dense tasks run the sparse formulation on the host — each
    unit's sub-schedule clears its dense routing masks, and the two
    paths agree per block-list, so results stay bit-identical for
    integer/bool attributes.  Per-unit updates fold through the same
    ``metadata["combine"]`` contract as device waves (``add`` folds the
    delta from iteration-start state, ``min``/``max`` fold elementwise;
    a leaf the kernel returns as the same tensor object is passed
    through).

    ``prepare`` runs against the *global* store view (``plan=None``), so
    host-computed positions index the global CSR the host already
    holds; nothing is sliced or rebased for the host lane.  The pool
    holds ``min(units, cpu_count - 1)`` threads.
    """

    def __init__(self, plan: "StreamingPlan", units: list[np.ndarray]) -> None:
        self.plan = plan
        self.units = [np.asarray(u, np.int64) for u in units]
        self._spec = _combine_spec(plan.alg)
        store = plan.store
        t0 = time.perf_counter()
        # the global CSR views, shared by every unit context
        self._globals = {k: _cpu_tensor(k, v) for k, v in dict(
            indptr=store.indptr, indices=store.indices, degrees=store.degrees,
            row_block_ptr=store.row_block_ptr, cuts=store.layout.cuts).items()}
        self._ctxs = [self._unit_context(ids) for ids in self.units]
        plan._phase["prepare"] += time.perf_counter() - t0
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(len(self.units), max(1, (os.cpu_count() or 2) - 1)),
            thread_name_prefix="repro-host")

    def _unit_context(self, ids: np.ndarray) -> Context:
        plan = self.plan
        store, sched = plan.store, plan.schedule
        hsched = sched.restrict(ids)
        # peeled dense tasks run the sparse formulation on the host:
        # clearing the routing masks sends every edge down the sparse
        # path and keeps prepare from bucketing dense-path work
        hsched.dense_task_mask = np.zeros(hsched.num_tasks, bool)
        hsched.dense_block_ids = np.zeros(0, np.int32)
        idx = segment_index(store.edge_segments(np.unique(hsched.blocklists)))
        extras = {}
        if plan.alg.prepare is not None:
            extras = _to_host(plan.alg.run_prepare(store, hsched, None))
            extras.pop("__workspace_bytes__", None)
        cpu = torch.device("cpu")
        ne = int(idx.size)
        return Context(
            src=_cpu_tensor("src", store.src[idx]),
            dst=_cpu_tensor("dst", store.dst[idx]),
            edge_block=_cpu_tensor("edge_block", store.edge_block[idx]),
            sparse_edge_mask=torch.ones(ne, dtype=torch.bool),
            dense_edge_mask=torch.zeros(ne, dtype=torch.bool),
            extras=to_device(extras, cpu), n=store.n, m=store.m, p=store.p,
            tile_dim=sched.tile_dim, device=cpu, **self._globals)

    def submit(self, state0: dict, it: int, direction: str = "push") -> list:
        """Snapshot the iteration-start state to the host and dispatch
        every unit into the pool; returns futures for :meth:`fold`.

        ``direction`` selects the sparse kernel variant: the host lane
        runs the same direction as the device waves of the iteration."""
        hstate = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                  for k, v in state0.items()}
        kernel, _ = kernels_for(self.plan.alg, direction)
        return [self._pool.submit(self._run_unit, u, hstate, it, kernel)
                for u in range(len(self.units))]

    def _run_unit(self, u: int, hstate: dict, it: int, kernel):
        try:
            return self._run_unit_inner(u, hstate, it, kernel)
        except HostTaskError:
            raise
        except Exception as e:
            # the blame is attached here, where unit, tasks and
            # iteration are known
            raise HostTaskError(u, self.units[u].tolist(), it, e) from e

    def _run_unit_inner(self, u: int, hstate: dict, it: int, kernel):
        alg = self.plan.alg
        faults = self.plan._faults
        t0 = time.perf_counter()
        with obs.span("host_compute", lane="host-compute", unit=u,
                      tasks=int(self.units[u].size)):
            if faults is not None:
                faults.fire("host.task", unit=u)
            new = kernel(self._ctxs[u], hstate, it)
        added = set(new) - set(hstate)
        if added:
            raise ValueError(
                f"{alg.name}: kernels added state leaves {sorted(added)}; "
                f"streaming requires kernels to write only leaves present in "
                f"init_state (declare scratch attributes there)")
        payload = {}
        for key, s0 in hstate.items():
            nw = new[key]
            if nw is s0:
                continue
            kind = self._spec(key)
            if kind not in _COMBINE_KINDS:
                raise ValueError(
                    f"state leaf {key!r} is modified by the kernels but "
                    f"declares no combine kind in metadata['combine'] (one of "
                    f"{_COMBINE_KINDS}); the host lane cannot fold its per-unit "
                    f"partial results")
            payload[key] = (kind, _host_value(nw - s0 if kind == "add" else nw))
        return payload, time.perf_counter() - t0

    def fold(self, results: list, acc: dict) -> tuple[dict, float]:
        """Merge every unit's payload (in unit order — deterministic) on
        the host and fold it ONCE into the accumulator on the plan's
        device, with :func:`_combine_leaf`'s semantics: exact for
        integer/boolean attributes, up to summation order for floats."""
        merged: dict[str, tuple[str, np.ndarray]] = {}
        busy_s = 0.0
        for payload, dt in results:
            busy_s += dt
            for key, (kind, val) in payload.items():
                if key not in merged:
                    merged[key] = (kind, val)
                elif kind == "add":
                    merged[key] = (kind, merged[key][1] + val)
                elif kind == "min":
                    merged[key] = (kind, np.minimum(merged[key][1], val))
                else:
                    merged[key] = (kind, np.maximum(merged[key][1], val))
        out = dict(acc)
        for key, (kind, val) in merged.items():
            v = to_device(np.asarray(val), self.plan.device)
            if kind == "add":
                out[key] = acc[key] + v
            elif kind == "min":
                out[key] = torch.minimum(acc[key], v)
            else:
                out[key] = torch.maximum(acc[key], v)
        return out, busy_s

    def close(self, wait: bool = False) -> None:
        """Shut the pool down; ``wait=True`` joins the worker threads."""
        self._pool.shutdown(wait=wait, cancel_futures=True)


# ----------------------------------------------------------------------
@dataclass
class _WaveSlab:
    """Host-side staged form of one wave: padded numpy arrays ready for
    one host→device copy.  ``arena_arrays`` names the buffers drawn from
    the staging arena (runtime assembly only)."""

    wave: Wave
    src: np.ndarray
    dst: np.ndarray
    edge_block: np.ndarray
    sparse_mask: np.ndarray
    dense_mask: np.ndarray
    tiles: np.ndarray | None
    tile_row_start: np.ndarray | None
    tile_col_start: np.ndarray | None
    csr: np.ndarray | None         # bucket-padded conformal CSR slice
    extras: Any                    # host tree, or None once hoisted resident
    run_dense: bool
    staged_bytes: int
    workspace_bytes: int           # kernel scratch estimate (not staged)
    edges: int
    segments: int                  # coalesced COO slices gathered
    csr_entries: int               # unpadded CSR slice length
    csr_segments: int              # coalesced CSR row-range gathers
    nd: int = 0                    # live tiles (the rest is bucket padding)
    arena_arrays: tuple = ()       # arena-owned buffers to recycle
    prep_ws: int = 0               # prepare-declared share of workspace


@dataclass
class _WaveRecipe:
    """The retained, array-free description of one planned wave (plus
    the cached post-hoist ``prepare`` outputs): the gathers are
    reproduced per iteration by the staging pipeline."""

    wave: Wave
    run_dense: bool
    staged_bytes: int
    workspace_bytes: int
    edges: int
    segments: int
    csr_entries: int
    csr_segments: int
    csr_bytes: int                 # padded CSR slab bytes (0 when none)
    src_bucket: int                # padded edge-slab width
    tile_bucket: int               # padded tile count (0 without tiles)
    nd: int
    extras: Any = None


@dataclass
class _PlanUnit:
    """One wave mid-planning: the assembled slab plus its *raw* prepare
    outputs, so :meth:`StreamingPlan._fit_unified` can re-derive the
    shared extras shapes after any split without re-running prepare."""

    slab: _WaveSlab
    raw_extras: Any = None
    base_staged: int = 0             # staged bytes excluding extras
    base_ws: int = 0
    prep_ws: int = 0                 # prepare-declared share of base_ws

    @classmethod
    def of(cls, slab: _WaveSlab) -> "_PlanUnit":
        return cls(slab=slab, raw_extras=slab.extras,
                   base_staged=slab.staged_bytes - tree_array_bytes(slab.extras),
                   base_ws=slab.workspace_bytes, prep_ws=slab.prep_ws)


@dataclass
class _Staged:
    """One wave's slab on the device: its tensors, extras, and the event
    that marks the end of its copy (``None`` on the CPU)."""

    arrays: dict
    extras: Any
    copied: "torch.cuda.Event | None"


# ----------------------------------------------------------------------
class StreamingPlan:
    """A plan whose execution streams budget-sized waves.

    Produced by ``compile_plan(alg, store, memory_budget=...)``.  Same
    ``run()`` contract as :class:`~repro_torch.core.engine.Plan` (hooks,
    post, iteration control, RunResult), but the per-iteration step is
    the three-stage pipelined wave loop described in the module
    docstring, and ``schedule_stats`` additionally carries a
    ``"streaming"`` dict: wave count, bytes staged per wave (each ≤
    budget), resident bytes, per-phase wall clock, arena bytes, copy
    time and the measured overlap.
    """

    def __init__(self, alg: BlockAlgorithm, store: BlockStore,
                 schedule: Schedule | None = None, *,
                 memory_budget: "int | str | MemoryBudget",
                 device: torch.device, num_devices: int = 1,
                 mode: str = "hybrid", tile_dim: int = 512,
                 dense_frac: float = 0.5, dense_density: float = 0.005,
                 rebalance_threshold: "float | str | None" = "auto",
                 pipeline_depth: int = PIPELINE_DEPTH,
                 share: bool = True, host_fraction: "float | str | None" = "auto",
                 direction: str | None = None,
                 faults: "str | FaultPlan | None" = None,
                 checkpoint_every: int | None = None,
                 checkpoint_dir: str | None = None,
                 retry_policy: RetryPolicy | None = None, **unported) -> None:
        from ..kernels.registry import host_executable

        reject_unported(**unported)
        self.alg = alg
        self.store = store
        self.device = torch.device(device)
        self.direction = resolve_direction(alg, direction)
        # None keeps the pre-direction contract (plain push, no controller)
        self._direction_requested = direction is not None
        self._direction_now = "push"
        self.budget = MemoryBudget.of(memory_budget)
        self._csr_mode = str(alg.metadata.get("csr", "resident"))
        if self._csr_mode not in _CSR_MODES:
            raise ValueError(f"{alg.name}: metadata['csr'] must be one of "
                             f"{_CSR_MODES}, got {self._csr_mode!r}")
        if not (rebalance_threshold is None or rebalance_threshold == "auto"
                or isinstance(rebalance_threshold, (int, float))):
            raise ValueError(
                "rebalance_threshold must be 'auto' (estimate-vs-observed "
                "divergence trigger), a float (compute-skew threshold), or "
                f"None (off); got {rebalance_threshold!r}")
        self.rebalance_threshold = rebalance_threshold
        # -- heterogeneous co-scheduling: the host CPU as a resource ---
        if not (host_fraction is None or host_fraction == "auto"
                or isinstance(host_fraction, (int, float))):
            raise ValueError(
                "host_fraction must be 'auto' (calibrated host/device split), a "
                "float in [0, 1] (fixed share of each wave's work peeled to the "
                f"host CPU), or None (off); got {host_fraction!r}")
        if (isinstance(host_fraction, (int, float))
                and not 0.0 <= float(host_fraction) <= 1.0):
            raise ValueError(f"host_fraction must lie in [0, 1]; got {host_fraction!r}")
        host_flag = str(alg.metadata.get("host", "auto"))
        if host_flag not in ("auto", "never"):
            raise ValueError(f"{alg.name}: metadata['host'] must be 'auto' or "
                             f"'never', got {host_flag!r}")
        blockers = []
        if alg.kernel_sparse is None:
            blockers.append("the algorithm has no kernel_sparse (host units run "
                            "the sparse formulation)")
        if host_flag == "never":
            blockers.append("metadata['host'] declares 'never'")
        uncertified = [k for k in alg.metadata.get("host_kernels", ())
                       if not host_executable(k)]
        if uncertified:
            blockers.append("metadata['host_kernels'] names kernels not certified "
                            f"host-executable: {uncertified}")
        self._host_capable = not blockers
        if (isinstance(host_fraction, (int, float)) and float(host_fraction) > 0.0
                and blockers):
            raise ValueError(f"{alg.name}: host_fraction={host_fraction!r} requires "
                             f"host-lane capability — " + "; ".join(blockers))
        self._host_frac_req = host_fraction
        # "auto" resolves to a zero split until calibration activates
        # it; an incapable algorithm silently stays device-only there
        self._host_frac = (host_fraction if self._host_capable
                           and host_fraction is not None else 0.0)
        # -- fault tolerance: injection, retry ladder, checkpoints -----
        (self._faults, self._policy, self._ckpt_every,
         self._ckpt_dir) = resilience_config(faults, retry_policy,
                                             checkpoint_every, checkpoint_dir)
        self._resil = ResilienceStats()
        self._injected_pub = 0          # injections already published
        self._sync_iters_left = 0       # transient sync-assembly window
        self._worker_deaths = 0
        self._host_failures = 0
        self._host_futs: list | None = None   # in-flight host futures
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self.schedule = schedule or build_schedule(
            alg, store, num_devices=num_devices, mode=mode, tile_dim=tile_dim,
            dense_frac=dense_frac, dense_density=dense_density,
            memory_budget=self.budget, direction=self.direction)
        self.host = build_host_ctx(store, self.schedule, self.device)
        # shape-driving prepare decisions (TC's bucket ladder) made once
        # against the FULL schedule
        self._plan_state = (alg.stage_plan(store, self.schedule)
                            if alg.stage_plan is not None else None)
        self._phase = {p: 0.0 for p in PHASES}
        on_card = self.device.type == "cuda"
        self._arena = _HostArena(pin=on_card)
        self._arena_deferred: list[tuple] = []
        self._pipe: _StagePipeline | None = None
        self._copy_stream = torch.cuda.Stream(self.device) if on_card else None
        self._copies: list[tuple] = []      # (start, end, bytes) not yet read
        self._h2d_s = 0.0                   # copy time, CUDA events on the card
        self._h2d_bytes = 0
        # "auto" prices the max over the push/pull dense variants
        self._workspace_decl = workspace_kernels(alg, self.direction)
        self._footprints = task_footprints(
            store, self.schedule, workspace_kernel=self._workspace_decl,
            stage_csr=self._csr_mode == "slice")
        self._host_ratio = _hetero_host_ratio_default()
        self._host_units: list[np.ndarray] = []
        self._host_lane: _HostLane | None = None
        self._host_seconds = 0.0
        self._last_host_busy_s = 0.0
        self._host_tasks_executed = 0
        self._host_measured = False
        self._hetero_refreshes = 0
        waves = build_waves(store, self.schedule, self.budget, self._footprints,
                            host_fraction=self._host_frac, host_ratio=self._host_ratio)
        self._apply_waves(waves, initial=True)
        # the one-time planning pass's host cost (per-wave prepare)
        self._planning_phase = dict(self._phase)
        self._resident = self._build_resident_context()
        self._step = _stream_step_for(alg, self.device, share=share)
        self._step_pull = (
            _stream_step_for(alg, self.device, share=share, direction="pull")
            if self.direction in ("pull", "auto") else None)
        self._calibration: dict | None = None
        self._bytes_staged = 0          # actual H2D traffic, all passes
        self._stall_s = 0.0             # main loop blocked on the queue
        self._assemble_overlapped_s = 0.0
        self._edge_free = int(alg.metadata.get("edge_free_iterations", 0))
        self._edge_free_bufs: _Staged | None = None
        # first-k-neighbors CSR for the edge-free sampling phase
        self._prefix_host = (csr_prefix(store.indptr, store.indices, self._edge_free)
                             if self._edge_free > 0 else None)
        self._prefix_dev: dict | None = None
        self._rebalanced = False
        self._reb_armed = True
        self._last_skew: float | None = None
        self._last_divergence: float | None = None

    # -- build side (planning pass) ------------------------------------
    def _apply_waves(self, waves: list[Wave], *, initial: bool = False) -> None:
        """Install a packed wave list: device tasks stay in the streaming
        pipeline (empty waves vanish), peeled ``host_task_ids`` become
        host-lane execution units, and the lane (thread pool + per-unit
        CPU contexts) is rebuilt."""
        if self._host_lane is not None:
            self._host_lane.close()
            self._host_lane = None
        self._host_units = [w.host_task_ids for w in waves if w.host_task_ids.size]
        self._slabs = self._plan_recipes([w for w in waves if w.task_ids.size],
                                         initial=initial)
        if (self._host_units and not self._slabs and not self._hoisted
                and self.alg.prepare is not None
                and (self.alg.post is not None
                     or int(self.alg.metadata.get("edge_free_iterations", 0)) > 0)):
            # fully host-peeled plan (host_fraction=1.0): post and the
            # edge-free phase still run against the resident context,
            # whose extras are normally hoisted from the device waves'
            # prepare outputs; no device wave exists here, so prepare
            # runs once against the full store instead
            extras = _to_host(self.alg.run_prepare(self.store, self.schedule,
                                                   self._plan_state))
            extras.pop("__workspace_bytes__", None)
            self._resident_extras = extras
            self._hoisted = True
        if self._host_units:
            self._host_lane = _HostLane(self, self._host_units)
        self.schedule.stats["waves"] = len(self._slabs)

    def _plan_recipes(self, waves: list[Wave], *,
                      initial: bool = False) -> list[_WaveRecipe]:
        """Assemble each wave once, decide hoisting (first build only),
        unify extras shapes across waves, verify/split against the
        budget, and retain only the recipes.  Wave-invariant extras are
        hoisted resident *before* the budget check: they are staged
        once, not per wave."""
        slabs = [self._assemble(w) for w in waves]
        if initial:
            self._decide_hoist(slabs)
        else:
            # a re-pack keeps the hoist decision (the resident context
            # already carries the hoisted extras)
            for s in slabs:
                self._strip_hoisted(s)
        if self._hoisted or self.alg.mesh_pack is None:
            slabs = self._fit_slabs(slabs)
        else:
            slabs = self._fit_unified([_PlanUnit.of(s) for s in slabs])
        return [self._recipe(s) for s in slabs]

    def _make_unit(self, wave: Wave) -> _PlanUnit:
        """Assemble one wave into a planning unit (raw extras kept)."""
        slab = self._assemble(wave)
        self._strip_hoisted(slab)
        return _PlanUnit.of(slab)

    def _fit_unified(self, units: list[_PlanUnit]) -> list[_WaveSlab]:
        """Cross-wave shape unification + budget fit, to fixpoint.

        Every wave's ``prepare`` outputs are padded to one shared shape
        set by the algorithm's ``mesh_pack`` (the waves are its leading
        axis), so the waves' extras share shapes.  Because padding can
        push a unified slab over the budget, the loop verifies the
        *unified* bytes, splits any offender and re-unifies until every
        wave fits.  When even a single-task wave cannot afford the
        shared caps, unification is abandoned for the whole plan."""
        if not units:
            return []
        while True:
            slabs = [u.slab for u in units]
            packed = _to_host(self.alg.mesh_pack([u.raw_extras for u in units]))
            ws_decl = packed.pop("__workspace_bytes__", None) if isinstance(packed, dict) else None
            if ws_decl is not None:
                ws = max(u.base_ws - u.prep_ws for u in units) + int(ws_decl)
            else:
                ws = max(u.base_ws for u in units)
            for w, u in enumerate(units):
                u.slab.extras = tree_map(
                    lambda leaf: leaf[w] if _is_array_leaf(leaf) else leaf, packed)
                u.slab.staged_bytes = u.base_staged + tree_array_bytes(u.slab.extras)
                u.slab.workspace_bytes = ws
            over = {w for w, u in enumerate(units)
                    if self._budget_load(u.slab) > self.budget.total_bytes}
            if not over:
                return slabs
            try:
                rebuilt: list[_PlanUnit] = []
                for w, u in enumerate(units):
                    if w in over:
                        a, b = split_wave(u.slab.wave, self.schedule, self._footprints)
                        rebuilt += [self._make_unit(a), self._make_unit(b)]
                    else:
                        rebuilt.append(u)
                units = rebuilt
            except ValueError:
                # a single-task wave cannot afford the shared caps: raw
                # per-wave shapes for the whole plan
                return self._fit_slabs([self._restore_raw(u) for u in units])

    @staticmethod
    def _restore_raw(u: _PlanUnit) -> _WaveSlab:
        """Undo shape unification on one planning unit."""
        slab = u.slab
        slab.workspace_bytes = u.base_ws
        slab.extras = u.raw_extras
        slab.staged_bytes = u.base_staged + tree_array_bytes(u.raw_extras)
        return slab

    @staticmethod
    def _recipe(slab: _WaveSlab) -> _WaveRecipe:
        return _WaveRecipe(
            wave=slab.wave, run_dense=slab.run_dense,
            staged_bytes=slab.staged_bytes, workspace_bytes=slab.workspace_bytes,
            edges=slab.edges, segments=slab.segments,
            csr_entries=slab.csr_entries, csr_segments=slab.csr_segments,
            csr_bytes=slab.csr.nbytes if slab.csr is not None else 0,
            src_bucket=int(slab.src.shape[-1]),
            tile_bucket=int(slab.tiles.shape[0]) if slab.tiles is not None else 0,
            nd=slab.nd, extras=slab.extras)

    def _reassemble(self, wave: Wave) -> _WaveSlab:
        """One wave → finished slab, honoring the standing hoist decision."""
        slab = self._assemble(wave)
        self._strip_hoisted(slab)
        return slab

    def _budget_load(self, slab) -> int:
        """The bytes the budget must bound: staged slab + kernel scratch."""
        return slab.staged_bytes + slab.workspace_bytes

    def _fit_slabs(self, slabs: list[_WaveSlab]) -> list[_WaveSlab]:
        out: list[_WaveSlab] = []
        pending = list(slabs)
        while pending:
            slab = pending.pop(0)
            if self._budget_load(slab) > self.budget.total_bytes:
                # split_wave raises for size-1 waves: the ≤ budget
                # invariant is never silently violated
                a, b = split_wave(slab.wave, self.schedule, self._footprints)
                pending[:0] = [self._reassemble(a), self._reassemble(b)]
                continue
            out.append(slab)
        return out

    def _assemble_runtime(self, recipe: _WaveRecipe, *, wave: int = -1) -> _WaveSlab:
        """Stage-1 body: reproduce one wave's slab into arena buffers.
        Pure gathers — ``prepare`` ran in the planning pass and its
        outputs are cached on the recipe; byte accounting is pinned to
        the recipe's planned numbers."""
        with obs.span("assemble", lane="staging", wave=wave, bytes=recipe.staged_bytes):
            if self._faults is not None:
                # fires on whichever thread assembles: a raise in the
                # background worker surfaces as WorkerDeath at get()
                self._faults.fire("stage.assemble", wave=wave)
            slab = self._assemble(recipe.wave, extras=recipe.extras, alloc=self._arena.take)
        slab.staged_bytes = recipe.staged_bytes
        slab.workspace_bytes = recipe.workspace_bytes
        return slab

    def _assemble(self, wave: Wave, *, extras: Any = _ABSENT, alloc=None) -> _WaveSlab:
        """Assemble one wave's padded host slab.

        Planning mode (``extras`` absent): build the wave-local store
        view, run the algorithm's ``prepare`` against it (timed into the
        ``prepare`` phase), and measure the staged bytes.  Runtime mode
        (``extras`` given): gathers only, into buffers from ``alloc``
        (the staging arena).  Every element of every buffer is written.
        """
        store, sched = self.store, self.schedule
        alloc = alloc or np.empty
        planning = extras is _ABSENT
        wsched = sched.restrict(wave.task_ids)
        blocks = np.unique(wsched.blocklists)
        segments = store.edge_segments(blocks)
        idx = segment_index(segments)
        ne = int(idx.size)
        eb = bucket_size(ne)
        src, dst, edge_block = (alloc(eb, np.int32) for _ in range(3))
        sparse_mask, dense_mask = alloc(eb, np.bool_), alloc(eb, np.bool_)
        arena_arrays = [src, dst, edge_block, sparse_mask, dense_mask]
        _gather(store.src, idx, src)
        _gather(store.dst, idx, dst)
        _gather(store.edge_block, idx, edge_block)
        _spread_padding(src, ne, store.n)
        dst[ne:] = src[ne:]
        dense_blocks = np.zeros(store.layout.num_blocks, bool)
        if wsched.dense_block_ids.size:
            dense_blocks[wsched.dense_block_ids] = True
        edense = dense_blocks[edge_block[:ne]]
        np.logical_not(edense, out=sparse_mask[:ne])
        dense_mask[:ne] = edense
        sparse_mask[ne:] = False
        dense_mask[ne:] = False

        # -- dense tiles (already materialized by build_schedule) ------
        tiles = trs = tcs = None
        nd = 0
        run_dense = (self.alg.kernel_dense is not None
                     and bool(wsched.dense_task_mask.any()))
        wstore = store
        if run_dense:
            ids = wsched.dense_block_ids
            pos = store.tile_positions(ids)
            nd = int(pos.size)
            tb = bucket_size(nd, minimum=1)
            t = sched.tile_dim
            tiles = alloc((tb, t, t), np.float32)
            trs, tcs = alloc(tb, np.int64), alloc(tb, np.int64)
            _gather(store.tiles, pos, tiles)
            _gather(store.tile_row_start, pos, trs)
            _gather(store.tile_col_start, pos, tcs)
            arena_arrays += [tiles, trs, tcs]
            if planning and self.alg.prepare is not None:
                rows, cols = store.tile_extents(ids)
                wstore = dc_replace(
                    store, tile_dim=t, tile_block_ids=ids.astype(np.int32),
                    tiles=tiles[:nd], tile_row_start=trs[:nd], tile_col_start=tcs[:nd],
                    tile_rows=rows, tile_cols=cols, _device_cache={})
        elif planning and self.alg.prepare is not None:
            # prepare must not see tiles the wave does not stage
            wstore = dc_replace(
                store, tile_dim=0, tile_block_ids=np.zeros(0, np.int32),
                tiles=np.zeros((0, 0, 0), np.float32),
                tile_row_start=np.zeros(0, np.int64), tile_col_start=np.zeros(0, np.int64),
                tile_rows=np.zeros(0, np.int32), tile_cols=np.zeros(0, np.int32),
                _device_cache={})

        # -- conformal CSR row slices (metadata["csr"] == "slice") -----
        csr = None
        csr_entries = csr_segments = 0
        if self._csr_mode == "slice":
            sl_idx, rbp_r, indptr_r, csr_segs = store.csr_slices(blocks)
            csr_entries = int(sl_idx.size)
            csr_segments = len(csr_segs)
            csr = alloc(bucket_size(csr_entries), np.int32)
            csr[:csr_entries] = sl_idx
            csr[csr_entries:] = 0
            arena_arrays.append(csr)
            if planning and self.alg.prepare is not None:
                # prepare sees the wave-local CSR view: positions it
                # computes from row_block_ptr index the staged slice
                wstore = dc_replace(wstore, indices=sl_idx, row_block_ptr=rbp_r,
                                    indptr=indptr_r, _device_cache={})

        ws = prep_ws = 0
        if planning:
            t0 = time.perf_counter()
            extras = _to_host(self.alg.run_prepare(wstore, wsched, self._plan_state))
            self._phase["prepare"] += time.perf_counter() - t0
            # prepare may declare device scratch under the reserved key:
            # a budget input, not a kernel input
            ws = prep_ws = int(extras.pop("__workspace_bytes__", 0))

        staged = (src.nbytes + dst.nbytes + edge_block.nbytes + sparse_mask.nbytes
                  + dense_mask.nbytes + tree_array_bytes(extras))
        if csr is not None:
            staged += csr.nbytes
        if tiles is not None:
            staged += tiles.nbytes + trs.nbytes + tcs.nbytes
            if planning:
                from ..kernels.registry import max_workspace_bytes, workspace_bytes

                wk = self._workspace_decl
                hints = dict(nd=int(tiles.shape[0]), tile_dim=sched.tile_dim)
                ws += (workspace_bytes(wk, **hints) if wk is not None
                       else max_workspace_bytes(**hints))
        return _WaveSlab(
            wave=wave, src=src, dst=dst, edge_block=edge_block,
            sparse_mask=sparse_mask, dense_mask=dense_mask,
            tiles=tiles, tile_row_start=trs, tile_col_start=tcs,
            csr=csr, extras=extras, run_dense=run_dense,
            staged_bytes=int(staged), workspace_bytes=int(ws),
            edges=ne, segments=len(segments),
            csr_entries=csr_entries, csr_segments=csr_segments, nd=nd,
            arena_arrays=tuple(arena_arrays) if alloc is not np.empty else (),
            prep_ws=int(prep_ws))

    def _decide_hoist(self, slabs: list[_WaveSlab]) -> None:
        """Wave-invariant ``prepare`` outputs (vertex-level arrays like
        PageRank's ``inv_deg``) are staged once as resident instead of
        once per wave per iteration."""
        self._resident_extras: dict = {}
        self._hoisted = False
        if not slabs:
            return
        first = slabs[0].extras
        if all(_trees_equal(s.extras, first) for s in slabs[1:]):
            self._resident_extras = first
            self._hoisted = True
            for s in slabs:
                self._strip_hoisted(s)

    def _strip_hoisted(self, slab: _WaveSlab) -> None:
        """Drop a slab's extras (and their byte cost) when they match the
        hoisted resident tree."""
        if (self._hoisted and slab.extras is not None
                and _trees_equal(slab.extras, self._resident_extras)):
            slab.staged_bytes -= tree_array_bytes(slab.extras)
            slab.extras = None

    def _put_resident(self, name: str, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if np.issubdtype(a.dtype, np.integer):
            a = _to_int32(name, a)
        return torch.from_numpy(a).to(self.device)

    def _build_resident_context(self) -> Context:
        """Vertex-level tensors only — the per-wave slab fields start
        empty and are swapped in by :func:`with_arrays` each wave.
        ``indices`` is the full CSR only in ``"resident"`` csr mode; in
        ``"slice"`` mode each wave swaps in its staged slice, and in
        ``"none"`` mode a minimal placeholder holds no ``m``-proportional
        memory.  The per-stripe width table from which each wave's tile
        extents are gathered is built here too."""
        store = self.store
        indices = (store.indices if self._csr_mode == "resident"
                   else np.zeros(bucket_size(0), np.int32))
        empty32 = torch.zeros(0, dtype=torch.int32, device=self.device)
        nomask = torch.zeros(0, dtype=torch.bool, device=self.device)
        cuts = store.layout.cuts
        self._cuts64 = torch.from_numpy(np.asarray(cuts, np.int64)).to(self.device)
        self._stripe_width = self._put_resident("stripe_width", np.diff(cuts))
        return Context(
            src=empty32, dst=empty32, edge_block=empty32,
            indptr=self._put_resident("indptr", store.indptr),
            indices=self._put_resident("indices", indices),
            degrees=self._put_resident("degrees", store.degrees),
            row_block_ptr=self._put_resident("row_block_ptr", store.row_block_ptr),
            cuts=self._put_resident("cuts", cuts),
            sparse_edge_mask=nomask, dense_edge_mask=nomask,
            extras=to_device(dict(self._resident_extras), self.device),
            n=store.n, m=store.m, p=store.p, tile_dim=self.schedule.tile_dim,
            device=self.device)

    # -- execute side --------------------------------------------------
    @property
    def num_waves(self) -> int:
        return len(self._slabs)

    @property
    def resident_device_bytes(self) -> int:
        """Device bytes of holding this streamed plan hot, state
        excluded: the resident vertex-level arrays (as host bytes; the
        card holds int64 arrays as int32), hoisted extras, and the
        double-buffered worst-case wave — two staged slabs and the
        kernel workspace."""
        worst = max((s.staged_bytes + s.workspace_bytes for s in self._slabs), default=0)
        return int(resident_bytes(self.store, include_csr=self._csr_mode == "resident")
                   + tree_array_bytes(self._resident_extras) + 2 * worst)

    @property
    def compile_count(self) -> int:
        """Wave steps built: 1 for a push plan, 2 with pull/auto."""
        return sum(s.builds for s in (self._step, self._step_pull) if s is not None)

    def _estimate_shares(self) -> np.ndarray:
        """Each wave's share of the schedule's total weight — the
        estimate the auto-rebalance trigger diverges against."""
        w = np.asarray([float(self.schedule.weights[s.wave.task_ids].sum())
                        for s in self._slabs])
        tot = w.sum()
        return w / tot if tot > 0 else np.full(w.shape, 1.0 / max(w.size, 1))

    def rebalance(self, wave_compute_s) -> bool:
        """Re-pack the wave queue against observed per-wave compute times.

        Evaluated automatically after the calibration pass.  Triggers
        (``rebalance_threshold``): ``"auto"`` — each wave's observed
        compute share against its estimated share, firing when the worst
        ratio reaches 2.0 and re-arming below 1.5, never below the noise
        floor (mean wave < 10 ms); a float — fire when max/mean of the
        times exceeds it (one-shot); ``None`` — off.

        On fire, each wave's time is attributed to its tasks in
        proportion to their weights and the queue is re-packed LPT
        against those times (:func:`repro_torch.core.membudget.repack_waves`),
        still under the byte budget.  Results are unchanged: per-wave
        folding is partition-invariant.  Returns True on a re-pack.
        """
        times = np.asarray(wave_compute_s, dtype=np.float64)
        if times.size != len(self._slabs) or len(self._slabs) < 2:
            return False
        mean = float(times.mean())
        if mean <= 0.0:
            return False
        self._last_skew = float(times.max() / mean)
        thr = self.rebalance_threshold
        if thr is None:
            return False
        if thr == "auto":
            est = self._estimate_shares()
            est_skew = float(est.max() * est.size) if est.size else 1.0
            self._last_divergence = self._last_skew / max(est_skew, 1.0)
            if mean < _REBALANCE_NOISE_FLOOR_S:
                return False            # noise-dominated: stand down
            # hysteresis latch: a fire disarms; only an evaluation under
            # the low watermark re-arms
            if self._last_divergence < _REBALANCE_LO:
                self._reb_armed = True
                return False
            if not self._reb_armed or self._last_divergence < _REBALANCE_HI:
                return False
            self._reb_armed = False
        else:
            if self._rebalanced or self._last_skew <= float(thr):
                return False
        task_t = np.zeros(self.schedule.num_tasks, dtype=np.float64)
        for t_w, slab in zip(times, self._slabs):
            ids = slab.wave.task_ids
            wts = self.schedule.weights[ids].astype(np.float64)
            tot = float(wts.sum())
            task_t[ids] = (t_w * wts / tot) if tot > 0 else t_w / ids.size
        if self._host_units:
            # host tasks never ran on the device: give them device-
            # equivalent times at the measured device rate so the
            # re-pack sees the whole schedule, then re-peel to keep the
            # standing host/device split across the new packing
            dev_w = float(sum(self.schedule.weights[s.wave.task_ids].sum()
                              for s in self._slabs))
            dev_rate = float(times.sum()) / dev_w if dev_w > 0 else 0.0
            for ids in self._host_units:
                task_t[ids] = self.schedule.weights[ids] * dev_rate
        new_waves = repack_waves(self.schedule, self.budget, self._footprints, task_t)
        if self._host_units:
            new_waves = peel_host_tasks(self.schedule, new_waves, self._host_frac,
                                        task_times=task_t, host_ratio=self._host_ratio,
                                        footprints=self._footprints)
        self._apply_waves(new_waves)
        self._edge_free_bufs = None     # stale slab-0 reference
        self._rebalanced = True
        obs.metrics.counter("stream.rebalances").inc()
        obs.instant("rebalance", lane="main", skew=self._last_skew,
                    waves=len(self._slabs))
        return True

    def _active_step(self) -> _StreamStep:
        """The wave step for the direction picked for this iteration."""
        return self._step_pull if self._direction_now == "pull" else self._step

    # -- clocks ----------------------------------------------------------
    def _mark(self):
        """A point on the device's timeline: a CUDA event recorded on the
        compute stream on the card, the host clock on the CPU."""
        if self._copy_stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _since(self, mark) -> float:
        """Seconds from ``mark`` to now on the same clock (waits for the
        device on the card)."""
        if self._copy_stream is None:
            return time.perf_counter() - mark
        end = self._mark()
        end.synchronize()
        return mark.elapsed_time(end) / 1e3

    def _sync(self) -> None:
        if self._copy_stream is not None:
            torch.cuda.synchronize(self.device)
            for start, end, nbytes in self._copies:
                self._h2d_s += start.elapsed_time(end) / 1e3
                self._h2d_bytes += nbytes
            self._copies.clear()

    # -- arena recycling -------------------------------------------------
    # A slab's arena buffers go back to the pool once the copy that read
    # them has landed (its event on the copy stream); on the CPU the
    # step that read them has returned by the time the slab is parked.
    def _park_for_recycle(self, slab: _WaveSlab, staged: _Staged) -> None:
        if slab.arena_arrays:
            self._arena_deferred.append((staged.copied, slab.arena_arrays))

    def _drain_recycle(self, *, force: bool = False) -> None:
        while self._arena_deferred:
            copied, arrays = self._arena_deferred[0]
            if copied is not None:
                if force:
                    copied.synchronize()
                elif not copied.query():
                    return
            self._arena.give(*arrays)
            self._arena_deferred.pop(0)

    def _to_device(self, tree: Any) -> Any:
        """``tree``'s numpy leaves as tensors on the plan's device: shared
        memory on the CPU; on the card, copies issued on the copy stream
        from the (pinned) host buffers."""
        if self._copy_stream is None:
            return tree_map(lambda l: torch.from_numpy(l) if isinstance(l, np.ndarray)
                             else l, tree)
        return tree_map(lambda l: torch.from_numpy(l).to(self.device, non_blocking=True)
                         if isinstance(l, np.ndarray) else l, tree)

    def _put_slab(self, slab: _WaveSlab, *, wave: int = -1) -> _Staged:
        """Stage 2: one host→device copy of an assembled wave slab.  The
        ``stage.device_put`` seam fires here, on the thread that issues
        the copy and before anything is queued on the copy stream."""
        if self._faults is not None:
            self._faults.fire("stage.device_put", wave=wave)
        self._bytes_staged += slab.staged_bytes
        arrays = dict(src=slab.src, dst=slab.dst, edge_block=slab.edge_block,
                      sparse_edge_mask=slab.sparse_mask, dense_edge_mask=slab.dense_mask)
        if slab.tiles is not None:
            arrays.update(tiles=slab.tiles, tile_row_start=slab.tile_row_start,
                          tile_col_start=slab.tile_col_start)
        if slab.csr is not None:
            arrays["indices"] = slab.csr
        t0 = time.perf_counter()
        with obs.span("device_put", lane="device", wave=wave, bytes=slab.staged_bytes):
            if self._copy_stream is None:
                staged = _Staged(self._to_device(arrays), self._to_device(slab.extras), None)
            else:
                compute = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                copied = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(self._copy_stream):
                    start.record()
                    staged = _Staged(self._to_device(arrays),
                                     self._to_device(slab.extras), copied)
                    copied.record()
                # allocated on the copy stream, used on the compute stream:
                # the allocator must not hand this memory out before the
                # compute stream is done with it
                for t in list(staged.arrays.values()) + [
                        x for x in _leaves(staged.extras) if isinstance(x, torch.Tensor)]:
                    t.record_stream(compute)
                compute.wait_event(copied)
                self._copies.append((start, copied, slab.staged_bytes))
        self._phase["device_put"] += time.perf_counter() - t0
        return staged

    def _wave_context(self, staged: _Staged, nd: int) -> Context:
        """The resident context with one wave's tensors swapped in; the
        tiles' extents are gathered from the resident stripe widths at
        each staged tile's origin (zero for the bucket's padding)."""
        arrays = dict(staged.arrays)
        if "tiles" in arrays:
            live = torch.arange(arrays["tiles"].shape[0], device=self.device) < nd
            for origin, extent in (("tile_row_start", "tile_rows"),
                                   ("tile_col_start", "tile_cols")):
                start = arrays[origin]
                stripe = torch.searchsorted(self._cuts64, start, right=True) - 1
                arrays[extent] = torch.where(live, self._stripe_width[stripe], 0).to(torch.int32)
                arrays[origin] = start.to(torch.int32)
        if staged.extras is not None:
            return with_arrays(self._resident, extras=staged.extras, **arrays)
        return with_arrays(self._resident, **arrays)

    def _step_wave(self, w: int, staged: _Staged, state0, acc, it: int):
        """Stage 3: run one staged wave's step."""
        recipe = self._slabs[w]
        with obs.span("compute", lane="device", wave=w):
            out = self._active_step()(self._wave_context(staged, recipe.nd),
                                      state0, acc, it, recipe.run_dense)
        if self._faults is not None:
            # firing on the accumulator lets `corrupt` damage the wave's
            # folded partial; recovery must discard it
            out = self._faults.fire("wave.compute", out, wave=w)
        return out

    def _calibrate(self, state0, acc, it: int):
        """The synchronous first iteration: a warm-up pass over every
        wave (result discarded), then each phase — assemble / copy /
        compute — timed per wave, so the overlap and rebalance inputs
        measure steady state.  Wave compute times come from CUDA events
        on the card."""
        nw = len(self._slabs)
        warm = state0
        for w in range(nw):
            t0 = time.perf_counter()
            slab = self._assemble_runtime(self._slabs[w], wave=w)
            self._phase["assemble"] += time.perf_counter() - t0
            staged = self._put_slab(slab, wave=w)
            warm = self._step_wave(w, staged, state0, warm, it)
            self._park_for_recycle(slab, staged)
            self._drain_recycle()
        del warm
        self._sync()
        self._drain_recycle(force=True)
        assemble_s = put_s = compute_s = 0.0
        wave_s: list[float] = []
        for w in range(nw):
            t0 = time.perf_counter()
            slab = self._assemble_runtime(self._slabs[w], wave=w)
            assemble_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            staged = self._put_slab(slab, wave=w)
            if staged.copied is not None:
                staged.copied.synchronize()
            put_s += time.perf_counter() - t0
            mark = self._mark()
            acc = self._step_wave(w, staged, state0, acc, it)
            dt = self._since(mark)
            compute_s += dt
            wave_s.append(dt)
            self._arena.give(*slab.arena_arrays)   # the copy has landed
        self._sync()
        self._phase["assemble"] += assemble_s
        self._phase["compute"] += compute_s
        self._calibration = dict(stage_s=assemble_s + put_s, compute_s=compute_s,
                                 assemble_s=assemble_s, put_s=put_s,
                                 wave_compute_s=wave_s)
        # a re-pack only pays off if another iteration will run it
        if (self.rebalance_threshold is not None
                and it + 1 < self.alg.max_iterations and self.rebalance(wave_s)):
            # re-time the re-packed waves on the next iteration
            self._calibration = None
        return acc

    def _run_edge_free(self, state0, it: int):
        """An iteration the algorithm declared edge-free (its kernels
        read no slab field and at most the prefix CSR — Afforest's
        sampling rounds): one representative wave, staged once and
        cached across the phase, gives the identical combined result."""
        if self._prefix_dev is None and self._prefix_host is not None:
            pptr, pidx = self._prefix_host
            self._prefix_dev = dict(indptr=self._put_resident("prefix_indptr", pptr),
                                    indices=self._put_resident("prefix_indices", pidx))
            self._bytes_staged += pptr.nbytes + pidx.nbytes
        if not self._slabs:
            ctx, run_dense = self._resident, False
        else:
            if self._edge_free_bufs is None:
                # cached across the phase: these buffers never re-enter
                # the arena
                self._edge_free_bufs = self._put_slab(
                    self._assemble_runtime(self._slabs[0], wave=0), wave=0)
            ctx = self._wave_context(self._edge_free_bufs, self._slabs[0].nd)
            run_dense = self._slabs[0].run_dense
        if self._prefix_dev is not None:
            ctx = with_arrays(ctx, **self._prefix_dev)
        return self._active_step()(ctx, state0, state0, it, run_dense)

    def _run_waves(self, state0, it: int):
        """One iteration's kernel work: the host units dispatched first,
        then the three-stage pipeline over every device wave, folding
        partials; calibration (synchronous, timed) on the first executed
        iteration, pipelined overlap afterwards.  Returns ``(state, wall
        seconds of an overlapped iteration or 0)``."""
        nw = len(self._slabs)
        lane = self._host_lane
        if nw == 0 and lane is None:
            return state0, 0.0
        if it < self._edge_free:
            # a fully host-peeled plan runs the edge-free kernel once on
            # the resident context: it is full-vertex, so that is the
            # whole iteration and the host lane idles
            return self._run_edge_free(state0, it), 0.0
        self._edge_free_bufs = None     # released once edge work begins
        self._prefix_dev = None
        # host units dispatch FIRST: they run while the card computes the
        # device waves and are gathered after them (both partitions judge
        # the same iteration-start state; folding is partition-invariant)
        host_futs = lane.submit(state0, it, self._direction_now) if lane is not None else None
        # stashed so that a failure anywhere in the wave loop can wait the
        # in-flight host work out before the iteration retries
        self._host_futs = host_futs
        if nw == 0:
            return self._gather_host(host_futs, state0), 0.0
        if self._calibration is None:
            # gather the host partials BEFORE the timed calibration pass:
            # the host threads stop competing with the phase timings, and
            # a rebalance fired inside _calibrate may rebuild the lane
            acc = self._gather_host(host_futs, state0)
            acc = self._calibrate(state0, acc, it)
            self._maybe_refresh_split(it)
            return acc, 0.0
        t0 = time.perf_counter()
        put0 = self._phase["device_put"]
        pipe = self._pipe
        if pipe is None and self.pipeline_depth > 0 and self._sync_iters_left == 0:
            # persistent worker, created at the first overlapped iteration
            pipe = self._pipe = _StagePipeline(self, self.pipeline_depth)
            pipe.request(range(nw))
        a0 = pipe.assemble_s if pipe is not None else 0.0
        s0 = pipe.stall_s if pipe is not None else 0.0
        fetched = 0

        def next_slab(i: int) -> _WaveSlab:
            nonlocal fetched
            if pipe is None:
                # synchronous baseline (pipeline_depth=0, or the fail-over
                # after the staging worker died)
                ta = time.perf_counter()
                s = self._assemble_runtime(self._slabs[i], wave=i)
                self._phase["assemble"] += time.perf_counter() - ta
                return s
            s = pipe.get()
            fetched += 1
            if fetched == nw and it + 1 < self.alg.max_iterations:
                # epoch drained: queue the next iteration's waves so they
                # assemble during post and the host hooks
                pipe.request(range(nw))
            return s

        acc = state0
        slab = next_slab(0)
        staged = self._put_slab(slab, wave=0)
        before = None           # wave w-1's end on the compute stream
        for w in range(nw):
            # fail fast: a host unit that already failed aborts the
            # iteration now, not after every device wave has streamed
            for f in host_futs or ():
                if f.done() and f.exception() is not None:
                    raise f.exception()
            acc = self._step_wave(w, staged, state0, acc, it)
            done = self._mark() if self._copy_stream is not None else None
            self._park_for_recycle(slab, staged)
            self._drain_recycle()
            if w + 1 < nw:
                slab = next_slab(w + 1)
                if before is not None:
                    # wave w-1's slab is free for the allocator only once
                    # its step has run: at most two slabs on the device
                    before.synchronize()
                staged = self._put_slab(slab, wave=w + 1)
            before = done
        del staged
        # the host partition ran during the loop above; any overhang past
        # the last device wave is waited out here, inside the wall clock
        acc = self._gather_host(host_futs, acc)
        self._sync()
        self._drain_recycle(force=True)
        wall = time.perf_counter() - t0
        put_d = self._phase["device_put"] - put0
        stall = 0.0
        if pipe is not None:
            asm = pipe.assemble_s - a0
            stall = pipe.stall_s - s0
            self._assemble_overlapped_s += asm
            self._stall_s += stall
            self._phase["assemble"] += asm
        self._phase["compute"] += max(wall - put_d - stall, 0.0)
        return acc, wall

    def _gather_host(self, futs, acc):
        """Wait on the host lane's unit futures and fold their partials
        into the running accumulator; publishes the host metrics."""
        if futs is None:
            return acc
        results = [f.result() for f in futs]
        self._host_futs = None
        acc, busy_s = self._host_lane.fold(results, acc)
        self._phase["host_compute"] += busy_s
        self._host_seconds += busy_s
        self._last_host_busy_s = busy_s
        ntasks = int(sum(u.size for u in self._host_units))
        self._host_tasks_executed += ntasks
        obs.metrics.counter("stream.host_tasks").inc(ntasks)
        obs.metrics.counter("stream.host_seconds").inc(busy_s)
        return acc

    # -- graceful degradation: the recovery ladder ---------------------
    def _run_waves_resilient(self, state0, it: int):
        """One iteration's wave work under the retry ladder.

        The fast path is a bare call.  On failure, every in-flight
        resource is quiesced, the failure is classified (oom / worker /
        host / fault), the matching recovery reshapes the plan, and the
        *whole iteration* re-runs from ``state0`` — partials fold from
        iteration-start state, so a retry never double-counts.  Bounded
        by ``RetryPolicy.max_retries``; an exhausted ladder re-raises."""
        policy = self._policy
        res = self._resil
        attempts = 0
        oom_count = 0
        release = False
        while True:
            if release:
                # the failed attempt's tensors are unreferenced now: hand
                # the allocator's cached blocks back so that the shrunk
                # waves can allocate
                torch.cuda.empty_cache()
                release = False
            try:
                out = self._run_waves(state0, it)
                if self._sync_iters_left > 0:
                    self._sync_iters_left -= 1
                return out
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                kind = classify(e)
                res.detected += 1
                attempts += 1
                obs.instant("failure", lane="resilience", it=it, kind=kind,
                            attempt=attempts, error=f"{type(e).__name__}: {e}")
                self._abort_inflight()
                release = (isinstance(e, torch.cuda.OutOfMemoryError)
                           and self._copy_stream is not None)
                if attempts > policy.max_retries:
                    res.record("exhausted", it=it, kind=kind)
                    raise
                if kind == "oom":
                    oom_count += 1
                    if oom_count >= policy.demote_after and self._host_capable:
                        self._demote_wave(e)
                        res.demotions += 1
                        obs.metrics.counter("stream.fault_demotions").inc()
                        res.record("demote", it=it, oom_count=oom_count)
                    else:
                        self._shrink_repack(oom_count)
                        res.oom_repacks += 1
                        res.record("oom_repack", it=it, factor=policy.backoff ** oom_count)
                elif kind == "worker":
                    self._worker_deaths += 1
                    res.failovers += 1
                    obs.metrics.counter("stream.fault_failovers").inc()
                    if self._worker_deaths >= policy.failover_after:
                        # the worker keeps dying: synchronous assembly
                        # (pipeline_depth=0 semantics) becomes permanent
                        self.pipeline_depth = 0
                        res.record("failover_permanent", it=it, deaths=self._worker_deaths)
                    else:
                        self._sync_iters_left = 1
                        res.record("failover_sync", it=it, deaths=self._worker_deaths)
                elif kind == "host":
                    self._host_failures += 1
                    if self._host_failures >= policy.failover_after:
                        self._disable_host_lane()
                        res.host_failovers += 1
                        res.record("host_disable", it=it, unit=getattr(e, "unit", None))
                    else:
                        res.record("host_retry", it=it, unit=getattr(e, "unit", None))
                else:
                    res.record("retry", it=it, kind=kind)
                res.retries += 1
                obs.metrics.counter("stream.fault_retries").inc()
                obs.instant("recovery", lane="resilience", it=it,
                            action=res.actions[-1]["action"])

    def _abort_inflight(self) -> None:
        """Quiesce every in-flight resource so that a retry starts clean:
        stop the staging worker (a dead one or a live one), wait out the
        dispatched host futures (their partials are discarded), let both
        streams finish (copies may still be in flight on the copy stream,
        and staged tensors are in use on the compute stream), and give
        the parked pinned buffers back once their copies have landed."""
        if self._pipe is not None:
            try:
                self._pipe.close(self._arena)
            finally:
                self._pipe = None
        futs, self._host_futs = self._host_futs, None
        for f in futs or ():
            try:
                f.result(timeout=60.0)
            except Exception:
                pass            # the retry dispatches from scratch
        self._sync()
        self._drain_recycle(force=True)

    def _shrink_repack(self, oom_count: int) -> None:
        """Device OOM: re-pack the device waves under an exponentially
        shrunk *effective* capacity (``budget × backoff**oom_count``), so
        each wave stages less at once.  The per-task bound is never
        relaxed — ``_fit_slabs`` still verifies every rebuilt wave
        against the ORIGINAL budget.  The host partition is kept."""
        eff = self.budget.scaled(self._policy.backoff ** oom_count)
        task_t = self.schedule.weights.astype(np.float64)
        packed = repack_waves(self.schedule, eff, self._footprints, task_t)
        host_ids = (np.concatenate(self._host_units) if self._host_units
                    else np.zeros(0, np.int64))
        waves: list[Wave] = []
        for w in packed:
            dev = w.task_ids[~np.isin(w.task_ids, host_ids)]
            if dev.size:
                waves.append(Wave(task_ids=dev, est_bytes=int(self._footprints[dev].sum())))
        waves += [Wave(task_ids=np.zeros(0, np.int64), est_bytes=0, host_task_ids=ids)
                  for ids in self._host_units]
        self._apply_waves(waves)
        self._calibration = None        # re-time the re-packed queue
        self._edge_free_bufs = None     # stale slab-0 reference

    def _demote_wave(self, exc: BaseException) -> None:
        """Repeated OOM: move the offending wave's tasks to the host lane
        wholesale (they are never staged there, so they stop pressing on
        device memory).  The wave is named by the failure's ``wave=``
        context when it has one, else the largest staged slab takes the
        blame."""
        if not self._slabs:
            return
        w = None
        ctx = getattr(exc, "ctx", None)
        if isinstance(ctx, dict):
            cw = ctx.get("wave")
            if isinstance(cw, int) and 0 <= cw < len(self._slabs):
                w = cw
        if w is None:
            w = max(range(len(self._slabs)), key=lambda i: self._slabs[i].staged_bytes)
        waves: list[Wave] = []
        for i, r in enumerate(self._slabs):
            if i == w:
                waves.append(Wave(task_ids=np.zeros(0, np.int64), est_bytes=0,
                                  host_task_ids=np.sort(r.wave.task_ids)))
            else:
                waves.append(Wave(task_ids=r.wave.task_ids, est_bytes=r.wave.est_bytes))
        waves += [Wave(task_ids=np.zeros(0, np.int64), est_bytes=0, host_task_ids=ids)
                  for ids in self._host_units]
        self._apply_waves(waves)
        self._calibration = None
        self._edge_free_bufs = None
        obs.instant("demote", lane="resilience", wave=w)

    def _disable_host_lane(self) -> None:
        """Repeated host-task failure: run device-only.  Every peeled task
        returns to the device wave queue and the auto split stays off for
        the rest of the plan's life."""
        self._host_capable = False
        self._host_frac = 0.0
        task_t = self.schedule.weights.astype(np.float64)
        self._apply_waves(repack_waves(self.schedule, self.budget, self._footprints, task_t))
        self._calibration = None
        self._edge_free_bufs = None
        obs.instant("host_disable", lane="resilience")

    def _maybe_refresh_split(self, it: int) -> None:
        """Adapt the ``"auto"`` host/device split to measured times.

        Runs right after each calibration pass.  Per-task device-
        equivalent times come from the calibrated wave computes (device
        tasks: wave time attributed by weight share; host tasks: their
        weight at the device rate); the schedule is re-packed LPT
        against them and re-peeled under the hide criterion
        (:func:`repro_torch.core.membudget.peel_host_tasks`).  The new
        split is applied only when it diverged beyond the hysteresis
        band (:func:`repro_torch.core.membudget.hetero_split_diverged`)
        or flipped between zero and nonzero.  The first activation
        forces one *probe* task per multi-task wave so that a host rate
        gets measured at all; once measured, the observed host/device
        ratio replaces the assumed ``REPRO_HETERO_HOST_RATIO``.  Below
        the noise floor (``REPRO_HETERO_NOISE_FLOOR_S``) the split stays
        where it is.  Each application invalidates the calibration, so
        the re-packed device waves are re-timed before the next
        evaluation."""
        if self._host_frac != "auto" or not self._host_capable:
            return
        if it + 1 >= self.alg.max_iterations:
            return                      # no later iteration would run it
        cal = self._calibration
        if cal is None or not self._slabs:
            return                      # a rebalance just re-packed
        wave_s = list(cal.get("wave_compute_s", []))
        if not wave_s or float(np.mean(wave_s)) < _hetero_noise_floor_s():
            return
        dev_w = float(sum(self.schedule.weights[s.wave.task_ids].sum() for s in self._slabs))
        if dev_w <= 0.0:
            return
        dev_rate = float(sum(wave_s)) / dev_w
        busy_s = self._last_host_busy_s
        if self._host_units and busy_s > 0.0 and dev_rate > 0.0:
            host_w = float(sum(self.schedule.weights[u].sum() for u in self._host_units))
            if host_w > 0.0:
                self._host_ratio = max((busy_s / host_w) / dev_rate, 1e-6)
                self._host_measured = True
        task_t = np.zeros(self.schedule.num_tasks, dtype=np.float64)
        for t_w, slab in zip(wave_s, self._slabs):
            ids = slab.wave.task_ids
            wts = self.schedule.weights[ids].astype(np.float64)
            tot = float(wts.sum())
            task_t[ids] = (t_w * wts / tot) if tot > 0 else t_w / max(ids.size, 1)
        for ids in self._host_units:
            task_t[ids] = self.schedule.weights[ids] * dev_rate
        waves = repack_waves(self.schedule, self.budget, self._footprints, task_t)
        waves = peel_host_tasks(self.schedule, waves, "auto", task_times=task_t,
                                host_ratio=self._host_ratio, footprints=self._footprints,
                                min_tasks=0 if self._host_measured else 1)
        host_ids = [w.host_task_ids for w in waves if w.host_task_ids.size]
        new_split = self.schedule.weight_share(np.concatenate(host_ids)) if host_ids else 0.0
        cur_split = (self.schedule.weight_share(np.concatenate(self._host_units))
                     if self._host_units else 0.0)
        if not (hetero_split_diverged(cur_split, new_split)
                or (new_split == 0.0) != (cur_split == 0.0)):
            return
        self._apply_waves(waves)
        self._edge_free_bufs = None     # stale slab-0 reference
        self._hetero_refreshes += 1
        self._calibration = None
        obs.instant("hetero_refresh", lane="main", split=float(new_split),
                    host_tasks=int(sum(u.size for u in self._host_units)),
                    waves=len(self._slabs))

    def _hetero_stats(self, phase_delta: dict) -> dict:
        """The ``schedule_stats["hetero"]`` block: the resolved
        host/device split, executed host work, and the per-resource
        makespans of this run."""
        host_ids = (np.concatenate(self._host_units) if self._host_units
                    else np.zeros(0, np.int64))
        return dict(
            enabled=bool(self._host_capable and self._host_frac_req is not None),
            host_fraction=self._host_frac_req,
            resolved_split=(float(self.schedule.weight_share(host_ids))
                            if host_ids.size else 0.0),
            host_tasks=int(host_ids.size),
            device_tasks=int(self.schedule.num_tasks - host_ids.size),
            host_units=len(self._host_units),
            host_ratio=float(self._host_ratio),
            host_ratio_measured=bool(self._host_measured),
            refreshes=int(self._hetero_refreshes),
            host_tasks_executed=int(self._host_tasks_executed),
            host_seconds=float(self._host_seconds),
            makespan=dict(device_s=float(phase_delta.get("compute", 0.0)),
                          host_s=float(phase_delta.get("host_compute", 0.0))),
        )

    def run(self, store: BlockStore | None = None, state: Any | None = None, *,
            _start_it: int = 0, _start_cont: bool = True,
            _ctrl_restore: dict | None = None) -> RunResult:
        """Execute the streamed iteration loop (same contract as
        :meth:`repro_torch.core.engine.Plan.run`).  The underscored
        keywords are :meth:`resume`'s continuation protocol — iteration
        counter, loop-continue flag, and the direction controller's
        restored decision history — not public surface."""
        if store is not None and store is not self.store:
            raise TypeError("StreamingPlan is bound to the store it was compiled "
                            "against; compile a new plan for a different graph")
        alg = self.alg
        if state is None:
            if alg.init_state is None:
                raise ValueError(f"{alg.name}: init_state required")
            state = alg.init_state(self.store)
        state = to_device(state, self.device)
        if self._host_units and self._host_lane is None:
            # close() tore the lane down; rebuild it for this run
            self._host_lane = _HostLane(self, self._host_units)
        ctrl = (DirectionController(alg, self.direction, self.store.n)
                if self._direction_requested else None)
        if ctrl is not None and _ctrl_restore is not None:
            restore_controller(ctrl, _ctrl_restore)
        self._direction_now = "push"
        t0 = time.perf_counter()
        it = int(_start_it)
        cont = bool(_start_cont)
        overlapped_wall = 0.0
        overlapped_iters = 0
        staged_before = self._bytes_staged
        h2d_before = (self._h2d_s, self._h2d_bytes)
        phase_before = dict(self._phase)
        asm_before = self._assemble_overlapped_s
        stall_before = self._stall_s
        try:
            while cont and it < alg.max_iterations:
                with obs.span("iteration", lane="main", it=it, alg=alg.name):
                    if alg.before is not None:
                        state = alg.before(self.host, state, it)
                    if ctrl is not None:
                        # one direction per iteration, across the device
                        # waves AND the host lane: bit-identity holds per
                        # direction, never across a mix
                        self._direction_now = ctrl.decide(state, it)
                    state, wall = self._run_waves_resilient(state, it)
                    if wall > 0.0:
                        overlapped_wall += wall
                        overlapped_iters += 1
                    if alg.post is not None:
                        state = alg.post(self._resident, state, it)
                    if alg.after is not None:
                        state, cont = alg.after(self.host, state, it)
                it += 1
                if self._ckpt_every and (it % self._ckpt_every == 0 or not cont):
                    self._save_checkpoint(state, it, cont, ctrl)
        finally:
            if self._pipe is not None:
                self._pipe.close(self._arena)
                self._pipe = None
        self._sync()
        dt = time.perf_counter() - t0
        result = alg.finalize(self.store, state) if alg.finalize else state
        phase_delta = {k: self._phase[k] - phase_before[k] for k in self._phase}
        staged_delta = self._bytes_staged - staged_before
        self._publish_metrics(iterations=it, seconds=dt, staged_delta=staged_delta,
                              phase_delta=phase_delta)
        stats = dict(
            self.schedule.stats,
            streaming=self._streaming_stats(
                state, overlapped_wall, overlapped_iters, staged_delta=staged_delta,
                phase_delta=phase_delta,
                asm_delta=self._assemble_overlapped_s - asm_before,
                stall_delta=self._stall_s - stall_before,
                h2d_s=self._h2d_s - h2d_before[0],
                h2d_bytes=self._h2d_bytes - h2d_before[1]),
            hetero=self._hetero_stats(phase_delta),
        )
        if ctrl is not None:
            stats["direction"] = ctrl.stats()
        if self._faults is not None or self._ckpt_every or self._resil.fired:
            # only runs that opted into fault tolerance (or actually
            # recovered) grow the stats dict
            stats["resilience"] = self._resil.snapshot(self._faults)
        return RunResult(result=result, state=state, iterations=it, seconds=dt,
                         schedule_stats=stats)

    # -- checkpoint / resume -------------------------------------------
    def _save_checkpoint(self, state, it: int, cont: bool, ctrl) -> None:
        save_run_checkpoint(self._ckpt_dir, self._resil, state, it, cont, ctrl)

    def resume(self, ckpt_dir: str | None = None, *, step: int | None = None) -> RunResult:
        """Continue a checkpointed run from its latest (or ``step``'s)
        snapshot; bit-identical to the uninterrupted run for integer/
        boolean attributes.  ``RunResult.iterations`` stays the absolute
        iteration count."""
        snap = load_run_checkpoint(self.alg, self.store,
                                   ckpt_dir if ckpt_dir is not None else self._ckpt_dir, step)
        return self.run(state=snap.state, _start_it=snap.it, _start_cont=snap.cont,
                        _ctrl_restore=snap.ctrl)

    def close(self) -> None:
        """Tear down every background resource: the staging worker
        (joined, not leaked), the host-lane pool (joined), and the parked
        arena buffers.  Idempotent; ``run()`` rebuilds both lazily, so a
        closed plan can run again."""
        if self._pipe is not None:
            self._pipe.close(self._arena)
            self._pipe = None
        if self._host_lane is not None:
            self._host_lane.close(wait=True)
            self._host_lane = None
        self._host_futs = None
        self._drain_recycle(force=True)

    def __enter__(self) -> "StreamingPlan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _publish_metrics(self, *, iterations: int, seconds: float,
                         staged_delta: int, phase_delta: dict) -> None:
        """Publish one run's deltas into the process-wide registry."""
        m = obs.metrics
        m.counter("stream.runs").inc()
        m.counter("stream.iterations").inc(iterations)
        m.histogram("stream.run_seconds").observe(seconds)
        for k, v in phase_delta.items():
            m.counter(f"stream.phase_seconds.{k}").inc(max(v, 0.0))
        m.counter("stream.bytes_staged").inc(max(int(staged_delta), 0))
        m.gauge("stream.arena_bytes").set_max(self._arena.bytes)
        m.gauge("stream.waves").set(len(self._slabs))
        m.gauge("stream.budget_bytes").set(self.budget.total_bytes)
        if self._slabs:
            m.gauge("stream.budget_high_water_bytes").set_max(
                max(self._budget_load(r) for r in self._slabs))
        if self._faults is not None:
            new = self._faults.injected - self._injected_pub
            if new > 0:
                m.counter("stream.fault_injected").inc(new)
            self._injected_pub = self._faults.injected

    def _streaming_stats(self, state, overlapped_wall: float, overlapped_iters: int, *,
                         staged_delta: int, phase_delta: dict, asm_delta: float,
                         stall_delta: float, h2d_s: float, h2d_bytes: int) -> dict:
        bytes_per_wave = [s.staged_bytes for s in self._slabs]
        calib = self._calibration or dict(stage_s=0.0, compute_s=0.0)
        eff = 0.0
        denom = min(calib["stage_s"], calib["compute_s"])
        if overlapped_iters and denom > 0:
            serial = calib["stage_s"] + calib["compute_s"]
            mean_wall = overlapped_wall / overlapped_iters
            eff = max(0.0, min(1.0, (serial - mean_wall) / denom))
        # how much of the background assembly the pipeline hid this run
        host_overlap = 0.0
        if asm_delta > 0:
            host_overlap = max(0.0, min(1.0, (asm_delta - stall_delta) / asm_delta))
        prefix_bytes = 0
        if self._prefix_host is not None:
            pptr, pidx = self._prefix_host
            prefix_bytes = pptr.nbytes + pidx.nbytes
        return dict(
            num_waves=len(self._slabs),
            budget_bytes=self.budget.total_bytes,
            bytes_per_wave=bytes_per_wave,
            workspace_per_wave=[s.workspace_bytes for s in self._slabs],
            mesh_devices=1,
            csr_mode=self._csr_mode,
            csr_bytes_per_wave=[s.csr_bytes for s in self._slabs],
            csr_segments=[s.csr_segments for s in self._slabs],
            # H2D traffic this run, counting the calibration warm-up pass
            # and edge-free single-wave iterations
            bytes_staged_total=int(staged_delta),
            # the copies' own time (CUDA events on the copy stream on the
            # card; on the CPU nothing is copied)
            h2d_seconds=float(h2d_s),
            h2d_bytes=int(h2d_bytes),
            resident_bytes=(resident_bytes(self.store, state,
                                           include_csr=self._csr_mode == "resident")
                            + tree_array_bytes(self._resident_extras)
                            + tree_array_bytes(state)),     # the accumulator copy
            edge_free_prefix_bytes=int(prefix_bytes),
            edge_buckets=sorted({s.src_bucket for s in self._slabs}),
            slab_shapes=len({_shape_key(s) for s in self._slabs}),
            coalesced_segments=[s.segments for s in self._slabs],
            overlap_efficiency=eff,
            pipeline_depth=self.pipeline_depth,
            host_stage_overlap=host_overlap,
            stall_seconds=float(stall_delta),
            trace_count=int(self.compile_count),
            arena_bytes=int(self._arena.bytes),
            arena_model_bytes=arena_model_bytes(bytes_per_wave,
                                                depth=max(self.pipeline_depth, 1)),
            arena_reuses=int(self._arena.reuses),
            phase_seconds={k: float(v) for k, v in phase_delta.items()},
            planning_phase_seconds={k: float(v) for k, v in self._planning_phase.items()},
            calibration=dict(calib),
            overlapped_iterations=overlapped_iters,
            # wave work of the overlapped iterations (post and hooks excluded)
            overlapped_wall_seconds=float(overlapped_wall),
            rebalanced=self._rebalanced,
            rebalance_mode=("off" if self.rebalance_threshold is None
                            else "auto" if self.rebalance_threshold == "auto" else "skew"),
            rebalance_skew=self._last_skew,
            rebalance_divergence=self._last_divergence,
        )


def _shape_key(recipe: _WaveRecipe) -> tuple:
    """A wave's slab shape: padded edge, CSR and tile widths, dense
    routing, and the shapes of its extras' array leaves."""
    ex = tuple(tuple(leaf.shape) for leaf in _leaves(recipe.extras) if _is_array_leaf(leaf))
    return (recipe.src_bucket, recipe.csr_bytes, recipe.tile_bucket, recipe.run_dense, ex)


def compile_streaming_plan(alg: BlockAlgorithm, store: BlockStore,
                           schedule: Schedule | None = None, **kw) -> StreamingPlan:
    """Explicit spelling of ``compile_plan(..., memory_budget=...)``."""
    return StreamingPlan(alg, store, schedule, **kw)
