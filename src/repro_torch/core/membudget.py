"""Device-memory footprint model + budget-sized wave packing (paper §4.3/§4.4).

PGAbB's headline claim is that a task only ever needs the blocks of ONE
block-list resident on the throughput device, so graphs that fit host
DRAM but not accelerator memory still run.  This module is the pricing
half of that subsystem: it puts a byte cost on every schedule task and
packs the LPT-ordered tasks into *waves* whose staged working set fits
an explicit ``memory_budget``.  The execution half (double-buffered
staging, partial-result combination) lives in :mod:`repro_torch.core.stream`.

Footprint model
---------------
A task's streamed working set prices three components:

* **COO slice** — the segmented-COO slab entries of every block in the
  task's block-list: ``src``/``dst``/``edge_block`` (int32) plus the two
  edge routing masks (bool) → :data:`COO_EDGE_BYTES` per edge.
* **Dense tiles** — for tile-path tasks, one ``tile_dim × tile_dim``
  float32 bitmap per distinct block, plus the two int64 tile-origin
  scalars (:func:`tile_bytes`).  Tiles shared by several tasks of one
  wave are staged once; the per-task price is therefore an upper bound
  and the wave builder re-prices the union.
* **CSR row slices** — when the algorithm declares
  ``metadata["csr"] == "slice"``, each task additionally prices the
  conformal CSR row ranges of its blocks
  (:data:`CSR_INDEX_BYTES` per edge, deduplicated per distinct block;
  routed through the registry's ``"csr_slice"`` workspace estimator).
  The executor stages exactly those slices per wave
  (:meth:`repro_torch.core.blocks.BlockStore.csr_slices`), so *no*
  edge-proportional array stays device-resident.
* **Kernel workspace** — per-kernel scratch estimates from the backend
  registry (:func:`repro_torch.kernels.registry.workspace_bytes`), e.g. the
  gathered ``xs``/``ys`` slices of ``spmv_tiles``.

Vertex-level attribute arrays (state pytree, ``degrees``, ``indptr``,
``row_block_ptr``) stay *resident* across waves; :func:`resident_bytes`
prices them so callers can see the full device picture.  The global CSR
``indices`` is resident only for algorithms that declare
``metadata["csr"] == "resident"`` (the compatibility default for custom
algorithms; every shipped algorithm declares ``"slice"`` or ``"none"``
— see :mod:`repro_torch.core.stream`).

Wave packing pads every wave's edge slab to one of a few fixed bucket
shapes (:func:`bucket_size`, a power-of-two ladder) so a handful of
slab shapes — and of pooled host staging buffers — serves every wave.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from .blocks import BlockStore
from .scheduler import Schedule

__all__ = [
    "MemoryBudget", "parse_bytes", "COO_EDGE_BYTES", "CSR_INDEX_BYTES",
    "TILE_HEADER_BYTES", "PIPELINE_DEPTH", "STATE_COPIES",
    "arena_model_bytes",
    "bucket_size", "task_edge_counts",
    "task_csr_edge_counts", "task_footprints", "tile_bytes",
    "dense_extra_bytes", "single_task_bytes",
    "resident_bytes", "tree_leaves", "tree_map", "tree_array_bytes", "batch_state_bytes",
    "TenantLedger", "Wave", "build_waves",
    "repack_waves",
    "HOST_RATIO_DEFAULT", "HETERO_HIDE_FACTOR",
    "peel_host_tasks", "hetero_split_diverged",
]

# src + dst + edge_block (int32) + sparse/dense edge masks (bool).
COO_EDGE_BYTES = 4 + 4 + 4 + 1 + 1
# default staging-pipeline depth: how many waves ahead the background
# staging worker may assemble (repro_torch.core.stream._StagePipeline).
PIPELINE_DEPTH = 2
# one staged CSR adjacency entry (int32) — see BlockStore.csr_slices.
CSR_INDEX_BYTES = 4
# per-tile origin scalars: tile_row_start + tile_col_start (int64).
TILE_HEADER_BYTES = 8 + 8
# batch-axis pricing: device copies of each query's state a batched
# step holds live at once — the iteration-start state plus the step's
# written/accumulator copy (post rebuilds every leaf).
STATE_COPIES = 2

_UNITS = {"b": 1, "kb": 10**3, "mb": 10**6, "gb": 10**9,
          "kib": 2**10, "mib": 2**20, "gib": 2**30}


def parse_bytes(budget: int | float | str) -> int:
    """``8_000_000``, ``"64MB"``, ``"512KiB"`` → bytes (int)."""
    if isinstance(budget, (int, float, np.integer, np.floating)):
        return int(budget)
    m = re.fullmatch(r"\s*([0-9.]+)\s*([kKmMgG]i?[bB]|[bB])?\s*", str(budget))
    if not m:
        raise ValueError(f"cannot parse memory budget {budget!r}")
    scale = _UNITS[(m.group(2) or "b").lower()]
    return int(float(m.group(1)) * scale)


@dataclass(frozen=True)
class MemoryBudget:
    """An explicit device-memory budget for streamed task working sets."""

    total_bytes: int

    def __post_init__(self) -> None:
        if self.total_bytes <= 0:
            raise ValueError("memory budget must be positive")

    @classmethod
    def of(cls, budget: "int | str | MemoryBudget") -> "MemoryBudget":
        if isinstance(budget, MemoryBudget):
            return budget
        return cls(parse_bytes(budget))

    def scaled(self, factor: float) -> "MemoryBudget":
        """A shrunk *effective* budget for OOM-backoff re-packing
        (clamped to ≥ 1 byte).  Only the packing capacity shrinks — the
        per-task staged-bytes bound is always verified against the
        original budget and is never relaxed."""
        return MemoryBudget(max(int(self.total_bytes * float(factor)), 1))


def bucket_size(k: int, *, minimum: int = 8) -> int:
    """Smallest power-of-two ≥ ``k`` — the fixed bucket ladder that keeps
    the number of distinct wave-slab shapes logarithmic in the largest
    wave."""
    k = max(int(k), minimum)
    return 1 << int(np.ceil(np.log2(k)))


def tile_bytes(tile_dim: int) -> int:
    """Staged bytes for one dense bitmap tile."""
    return tile_dim * tile_dim * 4 + TILE_HEADER_BYTES


def task_edge_counts(store: BlockStore, schedule: Schedule) -> np.ndarray:
    """(t,) edges across every block of each task's block-list."""
    bls = schedule.blocklists
    seg = np.diff(store.block_ptr)
    return seg[bls].sum(axis=1).astype(np.int64)


def task_csr_edge_counts(store: BlockStore, schedule: Schedule) -> np.ndarray:
    """(t,) CSR entries each task's conformal row slices stage.

    A block's conformal CSR content has exactly as many entries as the
    block has edges, so this is the per-task edge count with duplicate
    blocks inside one block-list (pattern mode) counted once.
    """
    bls = np.sort(schedule.blocklists, axis=1)
    seg = np.diff(store.block_ptr)
    first = np.ones(bls.shape, dtype=bool)
    if bls.shape[1] > 1:
        first[:, 1:] = bls[:, 1:] != bls[:, :-1]
    return (seg[bls] * first).sum(axis=1).astype(np.int64)


def task_footprints(store: BlockStore, schedule: Schedule, *,
                    workspace_kernel: "str | tuple | None" = None,
                    stage_csr: bool = False) -> np.ndarray:
    """(t,) bytes: the streamed working set of each task, per the model.

    COO slab + (dense tasks) bitmap tiles per distinct block + kernel
    workspace + (``stage_csr=True``) the task's conformal CSR row
    slices.  ``workspace_kernel`` names the registry kernel whose
    workspace estimator prices the dense path (algorithms declare it in
    ``metadata["workspace_kernel"]``) — or a tuple of names, charged at
    the max over them (how ``direction="auto"`` plans price both the
    push and pull dense variants); when unknown, the *maximum* over
    all registered estimators is charged — conservative by design.
    ``stage_csr`` mirrors the algorithm's ``metadata["csr"] == "slice"``
    declaration: per-wave sliced ``indices`` are staged device memory
    and must be priced like the COO slab.
    This is the scheduler-facing *estimate*; the wave builder verifies
    the assembled slabs against the budget and splits waves whose
    actual bytes (e.g. pattern-mode ``prepare`` items) exceed it.
    """
    from ..kernels.registry import registered_workspaces, workspace_bytes

    for wk in _workspace_names(workspace_kernel):
        if wk not in registered_workspaces():
            raise ValueError(
                f"workspace_kernel {wk!r} has no registered "
                f"estimator (known: {sorted(registered_workspaces())}); a "
                f"typo here would silently under-price dense tasks"
            )
    edges = task_edge_counts(store, schedule)
    out = edges * COO_EDGE_BYTES
    if stage_csr:
        # one registry call fetches the per-edge rate; the estimator is
        # linear, so the per-task bytes vectorize
        per_edge = workspace_bytes("csr_slice", csr_edges=1)
        out = out + task_csr_edge_counts(store, schedule) * per_edge
    if schedule.dense_task_mask.any():
        for t in np.nonzero(schedule.dense_task_mask)[0]:
            nd = int(np.unique(schedule.blocklists[t]).size)
            out[t] += dense_extra_bytes(nd, schedule.tile_dim,
                                        workspace_kernel)
    return out.astype(np.int64)


def _workspace_names(workspace_kernel) -> tuple:
    """Normalize a workspace declaration (name | tuple of variant
    names | None) to a tuple for validation and pricing loops."""
    if workspace_kernel is None:
        return ()
    if isinstance(workspace_kernel, str):
        return (workspace_kernel,)
    return tuple(workspace_kernel)


def dense_extra_bytes(nd: int, tile_dim: int,
                      workspace_kernel: "str | tuple | None" = None) -> int:
    """Dense-path surcharge for one task: ``nd`` staged bitmap tiles
    plus the kernel workspace estimate (worst case over the registry
    when the algorithm names no kernel; max over the named variants
    when a direction-capable algorithm names several).

    Deliberately *not* mesh-aware: a task is atomic on one device, so
    its footprint never shrinks with mesh size.  Per-device pricing of
    a whole wave's spread-out tiles goes through the registry
    estimators' ``devices`` hint instead (the mesh assembler prices the
    per-device padded tile count directly)."""
    from ..kernels.registry import max_workspace_bytes, workspace_bytes

    extra = nd * tile_bytes(tile_dim)
    names = _workspace_names(workspace_kernel)
    extra += (workspace_bytes(names, nd=nd, tile_dim=tile_dim)
              if names
              else max_workspace_bytes(nd=nd, tile_dim=tile_dim))
    return int(extra)


def single_task_bytes(store: BlockStore, blocklist, *, tile_dim: int = 0,
                      workspace_kernel: "str | tuple | None" = None,
                      stage_csr: bool = False, dense: bool = False) -> int:
    """Model bytes for one task's staged working set — the canonical
    single-task pricing shared by :func:`task_footprints` (vectorized
    over a schedule) and the scheduler's budget demotion check.

    COO prices the raw block-list (duplicates and all, matching
    :func:`task_edge_counts`); CSR slices and tiles stage each distinct
    block once."""
    from ..kernels.registry import workspace_bytes

    bl = np.atleast_1d(np.asarray(blocklist, dtype=np.int64))
    seg = np.diff(store.block_ptr)
    blocks = np.unique(bl)
    total = int(seg[bl].sum()) * COO_EDGE_BYTES
    if stage_csr:
        total += int(seg[blocks].sum()) * workspace_bytes("csr_slice",
                                                          csr_edges=1)
    if dense:
        total += dense_extra_bytes(int(blocks.size), tile_dim,
                                   workspace_kernel)
    return total


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists, tuples and dataclasses
    (a :class:`~repro_torch.core.context.Context`), in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure trees of dicts, lists and
    tuples (anything else is a leaf)."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_array_bytes(tree) -> int:
    """Total bytes of the array leaves of a tree (numpy arrays or
    tensors on any device); static leaves (ints, strings, ...) cost
    nothing."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, (np.ndarray, np.generic, torch.Tensor)):
            total += int(leaf.nbytes)
    return total


def batch_state_bytes(per_query_bytes: int, batch: int, *,
                      copies: int = STATE_COPIES) -> int:
    """Priced device bytes of ``batch`` query-state rows.

    ``per_query_bytes`` is one query's state pytree
    (:func:`tree_array_bytes` of its ``init_state``); a padded batch
    prices every row of the bucket — padding rows occupy real device
    memory even though their results are discarded.  ``copies`` models
    how many live copies of the state the batched step holds at once
    (:data:`STATE_COPIES`).  This is the admission controller's unit
    price: resident plan bytes + Σ batch_state_bytes of everything
    in flight must stay under the serving budget.
    """
    if batch < 0:
        raise ValueError("batch must be non-negative")
    return int(per_query_bytes) * int(batch) * int(copies)


class TenantLedger:
    """Per-tenant byte accounting for admitted serving work.

    Each tenant has an optional byte cap (``budgets`` per tenant, or
    ``default_budget`` for everyone unnamed; ``None`` means uncapped).
    The serving admission controller charges a query's priced footprint
    to its tenant while the query is queued-for-batch or running, and
    releases it on completion — so one tenant's burst queues behind its
    own cap instead of starving the others.
    """

    def __init__(self, budgets: dict | None = None,
                 default_budget: "int | str | None" = None) -> None:
        self._budgets = {
            str(k): parse_bytes(v) for k, v in (budgets or {}).items()
        }
        self._default = (
            parse_bytes(default_budget) if default_budget is not None else None
        )
        self._held: dict[str, int] = {}

    def budget(self, tenant: str) -> int | None:
        return self._budgets.get(str(tenant), self._default)

    def held(self, tenant: str) -> int:
        return self._held.get(str(tenant), 0)

    def fits(self, tenant: str, nbytes: int) -> bool:
        """Could ``nbytes`` EVER be admitted for this tenant (alone)?"""
        b = self.budget(tenant)
        return b is None or int(nbytes) <= b

    def can_charge(self, tenant: str, nbytes: int) -> bool:
        b = self.budget(tenant)
        return b is None or self.held(tenant) + int(nbytes) <= b

    def charge(self, tenant: str, nbytes: int) -> None:
        if not self.can_charge(tenant, nbytes):
            raise ValueError(
                f"tenant {tenant!r} over budget: holds {self.held(tenant)} "
                f"+ {int(nbytes)} > {self.budget(tenant)}"
            )
        self._held[str(tenant)] = self.held(tenant) + int(nbytes)
        obs.metrics.gauge("membudget.tenant_held_high_water_bytes").set_max(
            sum(self._held.values()))

    def release(self, tenant: str, nbytes: int) -> None:
        self._held[str(tenant)] = max(0, self.held(tenant) - int(nbytes))


def arena_model_bytes(slab_bytes, depth: int = PIPELINE_DEPTH,
                      devices: int = 1) -> int:
    """Model bytes of the staging arena for a plan's wave slabs.

    The pipelined stager holds up to ``depth`` assembled host slabs in
    its queue plus the one whose ``device_put`` is in flight, all drawn
    from pooled per-(bucket shape, dtype) buffers — so the arena's
    steady-state residency is bounded by ``(depth + 1)`` copies of the
    *largest* slab (priced through the registry's ``stage_arena``
    estimator, which also understands the per-device mesh split).  Host
    memory: the device-side bound stays "each staged slab ≤ budget".
    """
    from ..kernels.registry import workspace_bytes

    worst = max((int(b) for b in slab_bytes), default=0)
    return workspace_bytes("stage_arena", slab_bytes=worst, depth=depth,
                           devices=devices)


def resident_bytes(store: BlockStore, state=None, *,
                   include_csr: bool = True) -> int:
    """Bytes that stay on device across every wave: vertex-level arrays,
    the conformal row map, optionally the state pytree, and — only for
    ``metadata["csr"] == "resident"`` algorithms (``include_csr``) — the
    global CSR adjacency.  ``"slice"``/``"none"`` algorithms keep no
    edge-proportional array resident (the sliced ``indices`` are priced
    per wave instead)."""
    total = (
        store.indptr.nbytes
        + store.degrees.nbytes
        + store.row_block_ptr.nbytes
        + store.layout.cuts.nbytes
    )
    if include_csr:
        total += store.indices.nbytes
    if state is not None:
        total += tree_array_bytes(state)
    return int(total)


# ----------------------------------------------------------------------
#: Assumed host-vs-device slowdown per unit task weight when the host
#: lane has not been measured yet (``REPRO_HETERO_HOST_RATIO`` env var
#: overrides; the streaming executor replaces it with the observed
#: ratio after the first heterogeneous iteration).
HOST_RATIO_DEFAULT = 4.0
#: The ``"auto"`` split only peels a task to the host while the host
#: queue's predicted time stays under this fraction of the remaining
#: device time — host work must hide behind the device wave, with a
#: margin, so co-scheduling can only shorten the wave.
HETERO_HIDE_FACTOR = 0.9


@dataclass
class Wave:
    """One budget-sized unit of streamed work.

    ``task_ids`` are indices into the schedule's task list, sorted by
    leading block id so the COO gather coalesces into few contiguous
    segments.  ``est_bytes`` is the model estimate used for packing;
    the staged slab's actual (bucket-padded) bytes are measured by the
    stream binder and recorded in ``schedule_stats``.
    ``host_task_ids`` is the wave's host partition — tasks peeled off
    by :func:`peel_host_tasks` that run on the host CPU and never count
    against ``est_bytes`` (they are never staged).
    """

    task_ids: np.ndarray
    est_bytes: int
    host_task_ids: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))


def peel_host_tasks(schedule: Schedule, waves: list[Wave],
                    host_fraction: "float | str", *,
                    task_times: np.ndarray | None = None,
                    host_ratio: float = HOST_RATIO_DEFAULT,
                    footprints: np.ndarray | None = None,
                    min_tasks: int = 0) -> list[Wave]:
    """Split each wave into a device partition and a host partition.

    Candidates leave the device side lightest/sparsest first — sparse
    tasks before dense ones, then by per-task time (the schedule's LPT
    weights when no measured ``task_times`` are given), so the
    irregular long tail is what moves to the CPU while the dense tiles
    keep the accelerator.  A wave's device side is never emptied unless
    ``host_fraction >= 1``.

    Policies:

    * numeric ``f`` in ``(0, 1)`` — peel tasks until the host partition
      carries at least ``f`` of the wave's time (any positive ``f``
      peels at least one task from every multi-task wave);
    * ``f >= 1`` — everything runs on the host;
    * ``"auto"`` — greedy hide-behind-device rule: accept a candidate
      only while ``host_time × host_ratio`` stays under
      :data:`HETERO_HIDE_FACTOR` of the device time left in the wave.
      With no measured ``task_times`` the auto split stays at zero
      (nothing is known yet); ``min_tasks`` forces that many probe
      tasks per multi-task wave so the executor can measure the host
      throughput it needs to calibrate the ratio.

    Device ``est_bytes`` is re-priced from ``footprints`` (host tasks
    are never staged), so peeling can only shrink the staged slab —
    the per-wave byte budget is preserved by construction.
    """
    auto = isinstance(host_fraction, str)
    if auto and host_fraction != "auto":
        raise ValueError(f"host_fraction must be a number or 'auto', "
                         f"got {host_fraction!r}")
    if auto and task_times is None:
        # nothing measured yet — the auto split starts device-only and
        # only activates once the executor feeds calibrated task times
        return list(waves)
    times = np.asarray(task_times if task_times is not None
                       else schedule.weights, dtype=np.float64)
    dense = schedule.dense_task_mask
    out: list[Wave] = []
    for wave in waves:
        ids = np.concatenate([wave.task_ids, wave.host_task_ids]).astype(
            np.int64)
        if ids.size == 0:
            continue
        if not auto and float(host_fraction) >= 1.0:
            out.append(Wave(task_ids=np.zeros(0, np.int64), est_bytes=0,
                            host_task_ids=np.sort(ids)))
            continue
        # lightest / sparsest first: sparse tasks peel before dense,
        # then by time, ties by id for determinism
        cand = ids[np.lexsort((ids, times[ids], dense[ids]))]
        total_t = float(times[ids].sum())
        host: list[int] = []
        host_t = 0.0
        if auto:
            dev_t = total_t
            for t in cand[:-1]:             # never empty the device side
                tt = float(times[t])
                forced = len(host) < min_tasks
                hides = ((host_t + tt) * float(host_ratio)
                         <= HETERO_HIDE_FACTOR * (dev_t - tt))
                if not (forced or hides):
                    break
                host.append(int(t))
                host_t += tt
                dev_t -= tt
        elif float(host_fraction) > 0.0:
            target = float(host_fraction) * total_t
            for t in cand[:-1]:
                if host_t >= target:
                    break
                host.append(int(t))
                host_t += float(times[t])
        host_ids = np.asarray(sorted(host), dtype=np.int64)
        dev_ids = np.setdiff1d(ids, host_ids)
        lead = schedule.blocklists[dev_ids, 0]
        dev_ids = dev_ids[np.argsort(lead, kind="stable")]
        est = (int(footprints[dev_ids].sum()) if footprints is not None
               else wave.est_bytes)
        out.append(Wave(task_ids=dev_ids, est_bytes=est,
                        host_task_ids=host_ids))
    return out


def hetero_split_diverged(current: float, proposed: float, *,
                          rel: float = 0.25, abs_tol: float = 0.05) -> bool:
    """Hysteresis for the auto host/device split: re-plan only when the
    proposed host share moved by more than ``abs_tol`` absolute or
    ``rel`` relative to the current share — small drifts in measured
    task times must not thrash the wave plan every iteration."""
    return abs(float(proposed) - float(current)) > max(
        abs_tol, rel * abs(float(current)))


def build_waves(store: BlockStore, schedule: Schedule,
                budget: MemoryBudget,
                footprints: np.ndarray | None = None, *,
                devices: int = 1,
                host_fraction: "float | str" = 0.0,
                task_times: np.ndarray | None = None,
                host_ratio: float = HOST_RATIO_DEFAULT) -> list[Wave]:
    """Greedily pack LPT-ordered tasks into waves under ``budget``.

    Walking tasks heaviest-first (the schedule's LPT order) keeps each
    wave's load balanced the same way device packing does; a wave closes
    when the next task would push its estimate past the wave capacity.
    Inside a wave, tasks are re-sorted by leading block id so their
    segmented COO slices coalesce.

    ``budget`` is *per device*; with ``devices`` > 1 (mesh-cooperative
    streaming) one wave is processed cooperatively by the whole mesh, so
    the wave capacity is ``devices × budget`` — but a single task is
    atomic on one device, so any task whose model footprint exceeds the
    per-device budget is unrunnable regardless of mesh size: raise
    rather than silently oversubscribe.  The stream binder re-verifies
    the assembled per-device slabs and splits waves whose actual bytes
    overflow.

    ``host_fraction`` (with optional measured ``task_times`` and the
    host/device throughput ``host_ratio``) additionally peels each
    wave's lightest tasks into a host partition via
    :func:`peel_host_tasks` — heterogeneous co-scheduling where the
    host CPU runs the sparse long tail while the device runs the rest.
    """
    if footprints is None:
        footprints = task_footprints(store, schedule)
    capacity = budget.total_bytes * max(int(devices), 1)
    waves: list[Wave] = []
    cur: list[int] = []
    cur_bytes = 0
    for t in schedule.order:
        b = int(footprints[t])
        if b > budget.total_bytes:
            raise ValueError(
                f"task {int(t)} needs {b} bytes > per-device budget "
                f"{budget.total_bytes}; raise memory_budget or shrink "
                f"tile_dim/blocks (p)"
            )
        if cur and cur_bytes + b > capacity:
            waves.append(_close_wave(cur, cur_bytes, schedule))
            cur, cur_bytes = [], 0
        cur.append(int(t))
        cur_bytes += b
    if cur:
        waves.append(_close_wave(cur, cur_bytes, schedule))
    if (isinstance(host_fraction, str)
            or float(host_fraction) > 0.0):
        waves = peel_host_tasks(schedule, waves, host_fraction,
                                task_times=task_times,
                                host_ratio=host_ratio,
                                footprints=footprints)
    obs.metrics.counter("membudget.wave_builds").inc()
    obs.metrics.counter("membudget.waves_packed").inc(len(waves))
    return waves


def _close_wave(task_ids: list[int], est_bytes: int,
                schedule: Schedule) -> Wave:
    ids = np.asarray(task_ids, dtype=np.int64)
    lead = schedule.blocklists[ids, 0]
    return Wave(task_ids=ids[np.argsort(lead, kind="stable")],
                est_bytes=int(est_bytes))


def repack_waves(schedule: Schedule, budget: MemoryBudget,
                 footprints: np.ndarray, task_times: np.ndarray, *,
                 slack: float = 0.2, devices: int = 1) -> list[Wave]:
    """Re-pack every task into waves against *observed* per-task times.

    The paper's dynamic work queue, adapted to wave granularity: once
    the streaming executor has measured real per-wave compute times
    (and attributed them to tasks), the static LPT-by-estimate packing
    is replaced by LPT over the measured times.  A wave closes when the
    next task would push its byte estimate past the budget *or* its
    time load past the balanced target (total time over the bytes-only
    wave-count floor, stretched by ``slack``) — so one dominated tail
    wave gets its heavy tasks spread instead of serialized.

    As in :func:`build_waves`, ``budget`` is per device and the wave
    byte capacity is ``devices × budget``.
    """
    capacity = budget.total_bytes * max(int(devices), 1)
    t = np.asarray(task_times, dtype=np.float64)
    order = np.argsort(-t, kind="stable")
    # bytes-only greedy pass fixes the wave-count floor the time target
    # balances against (fewer waves than this cannot fit the budget)
    floor_waves, acc = 1, 0
    for i in order:
        b = int(footprints[i])
        if acc and acc + b > capacity:
            floor_waves += 1
            acc = 0
        acc += b
    total_t = float(t.sum())
    target = (
        (total_t / floor_waves) * (1.0 + slack) if total_t > 0 else np.inf
    )
    waves: list[Wave] = []
    cur: list[int] = []
    cur_bytes, cur_t = 0, 0.0
    for i in order:
        b = int(footprints[i])
        if cur and (cur_bytes + b > capacity
                    or cur_t + float(t[i]) > target):
            waves.append(_close_wave(cur, cur_bytes, schedule))
            cur, cur_bytes, cur_t = [], 0, 0.0
        cur.append(int(i))
        cur_bytes += b
        cur_t += float(t[i])
    if cur:
        waves.append(_close_wave(cur, cur_bytes, schedule))
    return waves


def split_wave(wave: Wave, schedule: Schedule,
               footprints: np.ndarray) -> tuple[Wave, Wave]:
    """Split a wave whose *assembled* slab overflowed the budget (the
    model under-priced algorithm-specific ``prepare`` outputs, or
    bucket padding pushed it over)."""
    ids = wave.task_ids
    if ids.size < 2:
        raise ValueError(
            "a single task's staged bytes (bucket-padded slab + prepare "
            "extras) exceed the memory budget even though its model "
            "footprint fits; raise memory_budget"
        )
    half = ids.size // 2
    a, b = ids[:half], ids[half:]
    return (
        Wave(task_ids=a, est_bytes=int(footprints[a].sum())),
        Wave(task_ids=b, est_bytes=int(footprints[b].sum())),
    )
