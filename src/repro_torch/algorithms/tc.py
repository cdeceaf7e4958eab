"""Triangle counting (paper §3.6, §5.4) — multi-block pattern-based mode.

The 2-D block TC of Yaşar et al. [46]: after degree ordering and DAG
orientation (u < v), a block-list is a triple ``L = (B_ij, B_ik, B_jk)``
with ``i ≤ j ≤ k`` — for every edge (u, v) in B_ij, the common neighbors
of u (from B_ik) and v (from B_jk) that land in stripe k are counted.
Conformal partitioning guarantees exactly three blocks per task and
that each partial adjacency is a *contiguous slice* of the global CSR
row (``row_block_ptr``).

* sparse path: per-(edge, stripe-k) items, bucketed by the padded length
  of the gathered (shorter) list; the membership test is a vectorized
  binary search on the other slice, over chunks of items so that the
  ``items × dp`` scratch stays bounded.
* dense path: for tile-resident triples, the ``tc_tiles`` kernel counts
  ``Σ (A_ik · A_jkᵀ) ∘ A_ij`` reading the three tiles of each triple in
  place.

The count is an exact int64 on both paths.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.blocks import build_block_store
from ..core.functors import BlockAlgorithm, Mode
from ..core.graph import Graph, degree_order, from_edges
from ..kernels.tc_tiles import tc_tiles

__all__ = ["tc_algorithm", "triangle_count", "orient_dag"]

#: most ``items × dp`` entries one chunk of the membership test holds
_SEARCH_CHUNK = 1 << 22


def orient_dag(g: Graph) -> Graph:
    """Degree-order (ascending) + keep only u<v edges → DAG whose wedge
    count is near-minimal (paper enables degree ordering for all systems)."""
    go, _ = degree_order(g, ascending=True)
    src, dst = go.coo()
    keep = src < dst
    return from_edges(src[keep], dst[keep], n=go.n, symmetrize=False,
                      name=g.name + "+dag")


def _make_blocklists(store):
    """Every (ij, ik, jk) with i ≤ j ≤ k whose three blocks hold edges,
    in (i, j, k) lexicographic order."""
    p = store.p
    nonempty = (np.diff(store.block_ptr) > 0).reshape(p, p)
    out = []
    for i in range(p):
        for j in np.flatnonzero(nonempty[i, i:]) + i:
            k = np.flatnonzero(nonempty[i, j:] & nonempty[j, j:]) + j
            if k.size:
                out.append(np.stack([np.full(k.size, i * p + j), i * p + k,
                                     j * p + k], axis=1))
    if not out:
        return np.zeros((0, 3), np.int64)
    return np.concatenate(out).astype(np.int64)


def _sparse_items(store, bls, dense_mask):
    """(sg, lg, sb, lb) membership-test items of every sparse task:
    start and length of the gathered (shorter) CSR slice, start and
    length of the searched one.  Items come task by task, edges in
    segment order within a task; the tasks' edge lists are expanded in
    chunks of at most ``_SEARCH_CHUNK`` (task, edge) pairs."""
    p = store.p
    rbp = store.row_block_ptr
    tasks = np.flatnonzero(~np.asarray(dense_mask, dtype=bool))
    b_ij = bls[tasks, 0]
    k_all = bls[tasks, 1] % p
    starts = store.block_ptr[b_ij]
    counts = store.block_ptr[b_ij + 1] - starts
    ends = np.cumsum(counts)
    cols = ([], [], [], [])
    a = 0
    while a < tasks.size:
        base = ends[a] - counts[a]                 # pairs before task a
        # tasks [a, b): at least one, at most _SEARCH_CHUNK pairs unless one task has more
        b = max(a + 1, int(np.searchsorted(ends, base + _SEARCH_CHUNK, side="right")))
        c = counts[a:b]
        # edge of pair i: its task's segment start + i's offset inside the task
        edge = (np.repeat(starts[a:b] - (ends[a:b] - c - base), c)
                + np.arange(int(c.sum()), dtype=np.int64))
        k = np.repeat(k_all[a:b], c)
        u = store.src[edge].astype(np.int64)
        v = store.dst[edge].astype(np.int64)
        su, lu = rbp[u, k], rbp[u, k + 1] - rbp[u, k]
        sv, lv = rbp[v, k], rbp[v, k + 1] - rbp[v, k]
        keep = (lu > 0) & (lv > 0)
        su, lu, sv, lv = su[keep], lu[keep], sv[keep], lv[keep]
        # gather the shorter side, binary-search the longer one
        swap = lu > lv
        for col, arr in zip(cols, (np.where(swap, sv, su), np.where(swap, lv, lu),
                                   np.where(swap, su, sv), np.where(swap, lu, lv))):
            col.append(arr)
        a = b
    if not cols[0]:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    return tuple(np.concatenate(col) for col in cols)


def _prepare(store, sched):
    """Bucketed sparse items + tile triple indices (host side, one-time)."""
    bls = sched.blocklists
    dense_mask = sched.dense_task_mask

    # ---- sparse items: (edge, k) pairs from sparse tasks --------------
    sg, lg, sb, lb = _sparse_items(store, bls, dense_mask)
    buckets = []
    if lg.size:
        ids = np.ceil(np.log2(np.maximum(lg, 1))).astype(np.int64)
        for b in np.unique(ids):
            sel = ids == b
            buckets.append(dict(
                dp=int(max(1, 2 ** b)),
                steps=int(max(1, np.ceil(np.log2(float(lb[sel].max()) + 1)))) + 1,
                sg=sg[sel], lg=lg[sel], sb=sb[sel], lb=lb[sel],
            ))
    extras = {"tc_buckets": buckets, "tc_tiles_idx": None}

    # ---- dense triples: tile index per block ---------------------------
    if dense_mask.any():
        tid_of_block = np.full(store.p * store.p, -1, np.int64)
        tid_of_block[store.tile_block_ids] = np.arange(store.tile_block_ids.size)
        extras["tc_tiles_idx"] = tid_of_block[bls[dense_mask]].astype(np.int32)
    return extras


def _bucket_count(indices: torch.Tensor, bucket: dict) -> torch.Tensor:
    """Σ over items of |gathered-slice ∩ searched-slice| (binary search)."""
    dp, steps = bucket["dp"], bucket["steps"]
    m = indices.shape[0]
    depth = torch.arange(dp, device=indices.device)
    total = torch.zeros((), dtype=torch.int64, device=indices.device)
    rows = max(1, _SEARCH_CHUNK // dp)
    for s in range(0, bucket["sg"].shape[0], rows):
        sg, lg, sb, lb = (bucket[k][s:s + rows] for k in ("sg", "lg", "sb", "lb"))
        vals = indices[(sg[:, None] + depth).clamp_max(m - 1)]
        mask = depth[None, :] < lg[:, None]
        end = (sb + lb)[:, None]
        lo = sb[:, None].expand(vals.shape)
        hi = end.expand(vals.shape)
        for _ in range(steps):
            mid = (lo + hi) // 2
            go = indices[mid.clamp_max(m - 1)] < vals  # lower bound: go right
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(go, hi, mid)
        found = (lo < end) & (indices[lo.clamp_max(m - 1)] == vals) & mask
        total += found.sum()
    return total


def _kernel_sparse(ctx, state, it):
    nt = state["nt"]
    for bucket in ctx.extras["tc_buckets"]:
        nt = nt + _bucket_count(ctx.indices, bucket)
    return dict(state, nt=nt)


def _kernel_dense(ctx, state, it):
    idx = ctx.extras["tc_tiles_idx"]
    if idx is None:
        return state
    return dict(state, nt=state["nt"] + tc_tiles(ctx.tiles, idx))


def tc_algorithm() -> BlockAlgorithm:
    return BlockAlgorithm(
        name="triangle_counting",
        mode=Mode.PATTERN,
        blocklist_size=3,
        make_blocklists=_make_blocklists,
        kernel_sparse=_kernel_sparse,
        kernel_dense=_kernel_dense,
        prepare=_prepare,
        init_state=lambda store: dict(nt=np.int64(0)),
        max_iterations=1,
        finalize=lambda store, state: int(state["nt"]),
        metadata=dict(workspace_kernel="tc_tiles"),
    )


def triangle_count(g: Graph, p: int = 8, **plan_kw) -> int:
    """End-to-end TC: degree order → DAG orient → block store → plan."""
    from ..core.engine import compile_plan

    dag = orient_dag(g)
    store = build_block_store(dag, p)
    return compile_plan(tc_algorithm(), store, **plan_kw).run().result
