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

Everything here is host-side numpy.  The budget-aware branches of the
reference scheduler belong to the streaming executor and are not
ported yet (ROADMAP A7).
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

    def makespan_ratio(self) -> float:
        """LPT makespan / ideal (mean) load — straggler headroom metric."""
        loads = np.zeros(self.num_devices)
        np.add.at(loads, self.device_assignment, self.weights)
        ideal = self.weights.sum() / max(self.num_devices, 1)
        return float(loads.max() / max(ideal, 1e-12))


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
    memory_budget=None,
    direction: str | None = None,  # accepted for signature parity; prices nothing
) -> Schedule:
    """Compose block-lists, estimate, sort, split paths, pack devices."""
    if memory_budget is not None:
        raise NotImplementedError(
            "memory_budget: the budget-aware scheduler belongs to the "
            "streaming executor, not ported yet (ROADMAP A7)")

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
    return sched
