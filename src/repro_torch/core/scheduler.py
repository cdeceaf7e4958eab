"""Workload-estimation based scheduler (paper §4.4).

The paper's scheduler (i) estimates each task's weight with the user's
``E`` functor (default: edges in the block-list), (ii) sorts tasks in
decreasing weight to expose bottleneck tasks, (iii) sends heavy tasks to
the throughput device and light ones to CPUs, with an optional cut-off
that CPUs never cross.

Here the same decisions appear at two levels:

* **Path split (K_D vs K_H).**  Heavy *and dense* tasks go to the tile
  path (dense bitmap tiles, the hand-written tile kernels); everything
  else goes to the edge path (segmented-COO gather/scatter).  The
  paper's cut-off becomes two knobs: ``dense_density`` (minimum block
  density) and ``dense_frac`` (the weight-ranked fraction the tile path
  claims).
* **Device packing.**  Tasks are LPT-packed (Longest Processing Time
  first — greedy on the sorted weights) onto ``num_devices`` slots.

With a ``memory_budget`` (the streaming executor forwards its budget
here) the planner is budget-aware: ``tile_dim`` shrinks until one
staged tile fits, and a task whose dense working set cannot fit the
budget stays on the sparse path.

Everything here is host-side numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .blocks import BlockStore
from .functors import BlockAlgorithm, default_estimate

__all__ = ["Schedule", "build_schedule", "lpt_assign"]


@dataclass
class Schedule:
    blocklists: np.ndarray        # (t, s) block ids per block-list (task)
    weights: np.ndarray           # (t,) E estimates
    order: np.ndarray             # (t,) task indices sorted by decreasing weight
    dense_task_mask: np.ndarray   # (t,) True → tile path
    dense_block_ids: np.ndarray   # unique block ids needing dense tiles
    tile_dim: int
    device_assignment: np.ndarray  # (t,) device slot per task (LPT)
    num_devices: int
    stats: dict = field(default_factory=dict)

    @property
    def num_tasks(self) -> int:
        return int(self.blocklists.shape[0])

    def restrict(self, task_ids: np.ndarray) -> "Schedule":
        """A sub-schedule over ``task_ids`` (wave-aware packing support).

        The streaming executor (:mod:`repro_torch.core.stream`) binds one
        sub-schedule per wave so algorithm ``prepare`` hooks see exactly
        the wave's tasks.  ``dense_block_ids`` is recomputed from the
        restricted tasks; weights/assignment are sliced; ``order``
        re-ranks within the subset.
        """
        ids = np.asarray(task_ids, dtype=np.int64)
        w = self.weights[ids]
        mask = self.dense_task_mask[ids]
        bls = self.blocklists[ids]
        dense_block_ids = (
            np.unique(bls[mask].ravel()).astype(np.int32)
            if mask.any() else np.zeros(0, np.int32)
        )
        return Schedule(
            blocklists=bls,
            weights=w,
            order=np.argsort(-w, kind="stable"),
            dense_task_mask=mask,
            dense_block_ids=dense_block_ids,
            tile_dim=self.tile_dim,
            device_assignment=self.device_assignment[ids],
            num_devices=self.num_devices,
            stats=dict(self.stats, restricted_from=self.num_tasks,
                       num_tasks=int(ids.size)),
        )

    def weight_share(self, task_ids) -> float:
        """Fraction of the schedule's total E-estimate weight carried by
        ``task_ids`` — how the heterogeneous executor reports its
        resolved host/device split ratio in ``schedule_stats``."""
        total = float(self.weights.sum())
        if total <= 0.0:
            return 0.0
        ids = np.asarray(task_ids, dtype=np.int64)
        return float(self.weights[ids].sum()) / total

    def makespan_ratio(self) -> float:
        """LPT makespan / ideal (mean) load — straggler headroom metric."""
        loads = np.zeros(self.num_devices)
        np.add.at(loads, self.device_assignment, self.weights)
        ideal = self.weights.sum() / max(self.num_devices, 1)
        return float(loads.max() / max(ideal, 1e-12))


def _demote_over_budget(alg: BlockAlgorithm, store: BlockStore,
                        bls: np.ndarray, fits: np.ndarray,
                        tile_dim: int, budget_bytes: int,
                        direction: str | None = None) -> int:
    """Clear ``fits`` for tasks whose dense-path staged working set
    cannot fit the budget; they run on the sparse path instead.

    Priced by :func:`repro_torch.core.membudget.single_task_bytes` — the
    same model :func:`~repro_torch.core.membudget.task_footprints`
    applies, so a task this check keeps is one the wave builder accepts.
    Returns the number of demoted tasks (for ``stats``)."""
    from .direction import workspace_kernels
    from .membudget import single_task_bytes

    wk = workspace_kernels(alg, direction)
    stage_csr = alg.metadata.get("csr") == "slice"
    demoted = 0
    for i in np.nonzero(fits)[0]:
        cost = single_task_bytes(store, bls[i], tile_dim=tile_dim,
                                 workspace_kernel=wk, stage_csr=stage_csr,
                                 dense=True)
        if cost > budget_bytes:
            fits[i] = False
            demoted += 1
    return demoted


def _budget_tile_dim(alg: BlockAlgorithm, tile_dim: int,
                     budget_bytes: int,
                     direction: str | None = None) -> int:
    """Budget-aware tile cut-off: halve ``tile_dim`` until one staged
    bitmap tile plus its kernel workspace fits the budget.  Blocks wider
    than the shrunken tile simply stay on the sparse path."""
    from ..kernels.registry import max_workspace_bytes, workspace_bytes
    from .direction import workspace_kernels
    from .membudget import tile_bytes

    wk = workspace_kernels(alg, direction)

    def cost(td: int) -> int:
        ws = (workspace_bytes(wk, nd=1, tile_dim=td) if wk is not None
              else max_workspace_bytes(nd=1, tile_dim=td))
        return tile_bytes(td) + ws

    while tile_dim > 64 and cost(tile_dim) > budget_bytes:
        tile_dim //= 2
    return tile_dim


def lpt_assign(weights: np.ndarray, num_devices: int) -> np.ndarray:
    """Longest-Processing-Time-first greedy packing → device id per task."""
    if num_devices == 1:  # every argmin below would pick slot 0
        return np.zeros(weights.shape[0], dtype=np.int32)
    order = np.argsort(-weights, kind="stable")
    loads = np.zeros(num_devices, dtype=np.float64)
    assign = np.zeros(weights.shape[0], dtype=np.int32)
    for t in order:
        d = int(np.argmin(loads))
        assign[t] = d
        loads[d] += float(weights[t])
    return assign


def build_schedule(
    alg: BlockAlgorithm,
    store: BlockStore,
    *,
    num_devices: int = 1,
    dense_frac: float = 0.5,
    dense_density: float = 0.005,
    tile_dim: int = 512,
    mode: str = "hybrid",          # "hybrid" | "sparse_only" | "dense_only"
    memory_budget=None,            # int | str | MemoryBudget | None
    direction: str | None = None,  # push | pull | auto | None — pricing only
) -> Schedule:
    """Compose block-lists, estimate, sort, split paths, pack devices.

    With ``memory_budget`` set, ``tile_dim`` shrinks until a single
    staged tile fits (:func:`_budget_tile_dim`), and a task is routed to
    the dense path only if its full staged working set fits the budget
    (:func:`_demote_over_budget`).  ``direction`` feeds that pricing
    only: ``"auto"`` charges the max over the push/pull dense variants.
    """
    budget_bytes = None
    if memory_budget is not None:
        from .membudget import MemoryBudget

        budget_bytes = MemoryBudget.of(memory_budget).total_bytes
        if mode != "sparse_only" and alg.kernel_dense is not None:
            tile_dim = _budget_tile_dim(alg, tile_dim, budget_bytes,
                                        direction)

    bls = alg.compose_blocklists(store)
    t = bls.shape[0]
    if alg.estimate is default_estimate:  # edges in the block-list, all at once
        bp = store.block_ptr
        weights = (bp[bls + 1] - bp[bls]).sum(axis=1).astype(np.float64)
    else:
        weights = np.asarray(
            [alg.estimate(store, bls[i]) for i in range(t)], dtype=np.float64
        )
    order = np.argsort(-weights, kind="stable")

    # ---- dense/sparse path split -------------------------------------
    dense_task_mask = np.zeros(t, dtype=bool)
    dense_demoted = 0
    if mode != "sparse_only" and alg.kernel_dense is not None and t:
        # a task is tile-eligible iff every block in its block-list fits a
        # tile and the *first* (edge) block clears the density cut-off
        cuts = store.layout.cuts
        width = np.diff(cuts)
        p = store.p
        gi, gj = np.divmod(bls, p)
        ranges_ok = (np.maximum(width[gi], width[gj]) <= tile_dim).all(axis=1)
        b0 = bls[:, 0]
        edges0 = store.block_ptr[b0 + 1] - store.block_ptr[b0]
        area0 = np.maximum(width[gi[:, 0]] * width[gj[:, 0]], 1)
        dens_ok = edges0.astype(np.float64) / area0.astype(np.float64) >= dense_density
        fits = ranges_ok & (dens_ok | (mode == "dense_only"))
        if budget_bytes is not None and alg.kernel_sparse is not None:
            dense_demoted = _demote_over_budget(
                alg, store, bls, fits, tile_dim, budget_bytes, direction)
        if mode == "dense_only":
            dense_task_mask = fits
        else:
            # heavy-first claim up to dense_frac of total weight (cut-off)
            budget = dense_frac * weights.sum()
            claimed = 0.0
            for tid in order:
                if not fits[tid]:
                    continue
                if claimed >= budget:
                    break
                dense_task_mask[tid] = True
                claimed += weights[tid]
    dense_block_ids = (
        np.unique(bls[dense_task_mask].ravel()).astype(np.int32)
        if dense_task_mask.any()
        else np.zeros(0, np.int32)
    )
    if dense_block_ids.size:
        store.materialize_tiles(dense_block_ids, tile_dim)

    assign = lpt_assign(weights, max(num_devices, 1))
    sched = Schedule(
        blocklists=bls,
        weights=weights,
        order=order,
        dense_task_mask=dense_task_mask,
        dense_block_ids=dense_block_ids,
        tile_dim=tile_dim,
        device_assignment=assign,
        num_devices=max(num_devices, 1),
    )
    w_dense = float(weights[dense_task_mask].sum())
    sched.stats = dict(
        num_tasks=t,
        total_weight=float(weights.sum()),
        dense_tasks=int(dense_task_mask.sum()),
        dense_weight_frac=w_dense / max(weights.sum(), 1e-12),
        makespan_ratio=sched.makespan_ratio(),
        mode=mode,
    )
    if budget_bytes is not None:
        sched.stats.update(
            budget_bytes=budget_bytes,
            tile_dim=tile_dim,            # post-shrink effective value
            dense_budget_demoted=dense_demoted,
        )
    return sched
