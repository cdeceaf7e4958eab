"""Partitioner & layout manager (paper §4.3).

PGAbB does not dictate a partitioning scheme but strongly encourages
**symmetric rectilinear (conformal) 2-D** partitioning in hybrid settings:
a single set of vertex cut points is used for both the row (source) and
column (destination) dimension, so block (i, j) holds exactly the edges
u∈V_i, v∈V_j.  Conformality means the row range of B_{ij} equals the
column range of B_{ki} — the property triangle counting relies on
(S_l = D_k, S_m = D_l in the paper's block-list (B_k, B_l, B_m)).

Two partitioners are provided, mirroring the paper:

* ``partition_1d``  — optimal contiguous 1-D edge-balanced partitioning
  (dynamic programming on the degree prefix sum; the paper ships a 1-D
  "optimal" partitioner for CPU-only runs).
* ``partition_symmetric_2d`` — symmetric rectilinear cuts balancing the
  per-stripe edge counts (greedy probe + refinement, the practical
  algorithm from Yaşar et al., arXiv:2009.07735).

The layout manager assigns integer block ids in row-major order by
default (paper §4.3.1) and supports a custom order hook (space-filling
curves etc.).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import Graph

__all__ = ["Layout", "partition_1d", "partition_symmetric_2d", "make_layout",
           "layout_from_cuts", "choose_p"]


@dataclass(frozen=True)
class Layout:
    """A conformal 2-D block layout of a graph.

    ``cuts`` is the shared (p+1,) vertex cut vector; block (i, j) covers
    sources ``[cuts[i], cuts[i+1])`` and destinations ``[cuts[j], cuts[j+1])``.
    ``block_ids`` maps grid position → block id; ``order`` is its inverse
    (block id → (i, j)).
    """

    cuts: np.ndarray           # (p+1,) int64 shared row/col cuts — conformal
    p: int                     # grid dimension (p × p blocks)
    block_ids: np.ndarray      # (p, p) int32
    block_edge_counts: np.ndarray  # (p, p) int64
    grid_pos: np.ndarray | None = None  # (p², 2) int32 inverse: id → (i, j)

    @property
    def num_blocks(self) -> int:
        return self.p * self.p

    def block_of_vertex(self, v: int) -> int:
        return int(np.searchsorted(self.cuts, v, side="right") - 1)

    def grid_of(self, block_id: int) -> tuple[int, int]:
        if self.grid_pos is not None:  # O(1): make_layout precomputes
            i, j = self.grid_pos[block_id]
            return int(i), int(j)
        pos = np.argwhere(self.block_ids == block_id)  # legacy Layouts only
        return int(pos[0, 0]), int(pos[0, 1])

    def rows(self, i: int) -> tuple[int, int]:
        return int(self.cuts[i]), int(self.cuts[i + 1])

    def max_stripe_edges(self, g: Graph) -> int:
        """Heaviest row stripe's edge count — an upper bound on any
        single block (and therefore any single-block task footprint)."""
        return _heaviest_stripe(_edge_prefix(g), self.cuts)


def _edge_prefix(g: Graph) -> np.ndarray:
    """Prefix sum of degrees: edges with source < v."""
    return g.indptr.astype(np.int64)


def _heaviest_stripe(pre: np.ndarray, cuts: np.ndarray) -> int:
    """Max edges in any row stripe of ``cuts`` given the edge prefix."""
    return int(np.max(pre[cuts[1:]] - pre[cuts[:-1]]))


def partition_1d(g: Graph, parts: int) -> np.ndarray:
    """Optimal contiguous 1-D partitioning of vertices into ``parts`` by edges.

    Minimizes the maximum per-part edge count over contiguous vertex ranges
    using parametric search over the bottleneck value (exact for contiguous
    1-D chains-on-chains partitioning).
    """
    pre = _edge_prefix(g)
    total = pre[-1]
    lo, hi = (total + parts - 1) // max(parts, 1), total

    def feasible(bound: int) -> np.ndarray | None:
        cuts = [0]
        cur = 0
        for _ in range(parts):
            # furthest vertex such that edges in (cur, v] <= bound
            target = pre[cuts[-1]] + bound
            v = int(np.searchsorted(pre, target, side="right") - 1)
            v = max(v, cuts[-1] + 1) if cuts[-1] < g.n else cuts[-1]
            v = min(v, g.n)
            cuts.append(v)
            if v >= g.n:
                break
        if cuts[-1] < g.n:
            return None
        while len(cuts) < parts + 1:
            cuts.append(g.n)
        return np.asarray(cuts[: parts + 1], dtype=np.int64)

    best = None
    while lo < hi:
        mid = (lo + hi) // 2
        c = feasible(mid)
        if c is not None:
            best, hi = c, mid
        else:
            lo = mid + 1
    if best is None:
        best = feasible(hi)
    assert best is not None
    return best


def _stripe_loads(g: Graph, cuts: np.ndarray) -> np.ndarray:
    """Edges per row stripe for the given cuts."""
    pre = _edge_prefix(g)
    return pre[cuts[1:]] - pre[cuts[:-1]]


def partition_symmetric_2d(g: Graph, p: int, *, refine_iters: int = 8) -> np.ndarray:
    """Symmetric rectilinear cuts: one (p+1,) cut vector for rows AND columns.

    Starts from the 1-D edge-balanced cuts (rows) and refines by probing:
    because the partition is symmetric, balancing row stripes also tends to
    balance column stripes on (near-)symmetric graphs — the paper's
    undirected preprocessing guarantees a symmetric adjacency structure.
    """
    if p <= 0:
        raise ValueError("p must be positive")
    if p == 1:
        return np.array([0, g.n], dtype=np.int64)
    cuts = partition_1d(g, p)
    # refinement: move each interior cut to the local optimum given neighbors
    pre = _edge_prefix(g)
    for _ in range(refine_iters):
        moved = False
        for k in range(1, p):
            lo_v, hi_v = int(cuts[k - 1]) + 1, int(cuts[k + 1]) - 1
            if lo_v > hi_v:
                continue
            # balance edges between stripe k-1 and stripe k
            target = (pre[cuts[k - 1]] + pre[cuts[k + 1]]) / 2.0
            v = int(np.searchsorted(pre, target, side="left"))
            v = min(max(v, lo_v), hi_v)
            if v != cuts[k]:
                cuts[k] = v
                moved = True
        if not moved:
            break
    return cuts.astype(np.int64)


def choose_p(g: Graph, memory_budget, *, safety: int = 2,
             p_max: int = 256, devices: int = 1) -> int:
    """Budget-aware partitioner grain: the smallest power-of-two ``p``
    whose heaviest row stripe fits ``1/safety`` of the memory budget.

    A single-block task can never stage more edges than its row stripe
    holds, so bounding the stripe bounds every task footprint the wave
    packer will see — the partition is made budget-aware up front
    instead of relying on ``build_waves`` to reject oversized tasks
    after the fact.  ``safety`` leaves headroom for bucket padding,
    per-edge routing masks, CSR slices and kernel workspace.

    ``memory_budget`` is the *per-device* budget; ``devices`` > 1
    (mesh-cooperative streaming) additionally requires ``p² ≥ devices``
    so one wave can carry at least one single-block task per mesh
    device.  Tasks stay atomic per device, so the stripe cap itself
    does not relax with mesh size.
    """
    from .membudget import COO_EDGE_BYTES, CSR_INDEX_BYTES, MemoryBudget

    per_edge = COO_EDGE_BYTES + CSR_INDEX_BYTES
    cap = MemoryBudget.of(memory_budget).total_bytes // (safety * per_edge)
    pre = _edge_prefix(g)
    p = 1
    while True:
        # probe with the cuts the layout will actually use
        cuts = partition_symmetric_2d(g, p) if p > 1 else np.array([0, g.n])
        heaviest = _heaviest_stripe(pre, cuts)
        fits = heaviest <= cap and p * p >= max(int(devices), 1)
        if fits or p >= p_max:
            # p_max is returned even unverified — a hub row can make the
            # cap unreachable by any contiguous partition; build_waves
            # still rejects genuinely oversized tasks downstream
            return p
        p *= 2


def make_layout(g: Graph, p: int, *, order: str = "row_major") -> Layout:
    """Build the conformal layout + per-block edge counts (for E estimates)."""
    return layout_from_cuts(g, partition_symmetric_2d(g, p), order=order)


def layout_from_cuts(g: Graph, cuts: np.ndarray, *,
                     order: str = "row_major") -> Layout:
    """The layout of ``g`` under a given ``(p+1,)`` cut vector."""
    cuts = np.asarray(cuts, dtype=np.int64)
    p = int(cuts.shape[0]) - 1
    src, dst = g.coo()
    bi = np.searchsorted(cuts, src, side="right") - 1
    bj = np.searchsorted(cuts, dst, side="right") - 1
    counts = np.bincount(bi * p + bj, minlength=p * p).reshape(p, p)
    ids = np.arange(p * p, dtype=np.int32)
    if order == "row_major":
        block_ids = ids.reshape(p, p)
    elif order == "snake":
        block_ids = ids.reshape(p, p).copy()
        block_ids[1::2] = block_ids[1::2, ::-1]
    else:
        raise ValueError(f"unknown block order {order!r}")
    # invert block_ids once: grid_pos[id] = (i, j) — grid_of is then O(1)
    # instead of an O(p²) argwhere per call
    grid_pos = np.zeros((p * p, 2), dtype=np.int32)
    ii, jj = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
    grid_pos[block_ids.ravel()] = np.stack([ii.ravel(), jj.ravel()], axis=1)
    return Layout(cuts=cuts, p=p, block_ids=block_ids,
                  block_edge_counts=counts, grid_pos=grid_pos)
