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
  place, and only inside their blocks' rectangles (the tiles' extents).

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


def _bucket_ids(lg: np.ndarray) -> np.ndarray:
    return np.ceil(np.log2(np.maximum(lg, 1))).astype(np.int64)


def _steps(lb: np.ndarray) -> int:
    """Binary-search rounds that settle every search over lengths ``lb``."""
    return int(max(1, np.ceil(np.log2(float(lb.max()) + 1)))) + 1


def _stage_plan(store, sched):
    """The cross-wave bucket plan: one dp/steps ladder for the plan.

    Computed once from the full store and schedule (the streaming
    executor calls it before any per-wave ``prepare``): the union of
    every sparse item's dp bucket, with ``steps`` the global max search
    depth per bucket.  Every wave then emits exactly these buckets, so
    the waves' extras share a handful of shapes.  Item lengths come from
    differences of ``row_block_ptr`` rows, so they are invariant under
    the per-wave CSR rebasing.
    """
    _, lg, _, lb = _sparse_items(store, sched.blocklists, sched.dense_task_mask)
    if not lg.size:
        return dict(dp_steps=())
    ids = _bucket_ids(lg)
    return dict(dp_steps=tuple((int(2 ** b), _steps(lb[ids == b]))
                               for b in np.unique(ids)))


def _prepare(store, sched, plan=None):
    """Bucketed sparse items + tile triple indices (host side, one-time).

    With a ``plan`` (the streaming executor passes the shared
    :func:`_stage_plan` output), the emitted buckets follow the plan's
    dp/steps ladder exactly: buckets this wave has no items for still
    appear, and item counts pad up the power-of-two ladder with neutral
    items (``lg = lb = 0`` — the mask and the lower-bound check both
    reject them).  Dense triples pad with ``-1`` rows, which count
    nothing.  The membership test's device scratch is declared under
    ``__workspace_bytes__`` for the executor's budget (never a kernel
    input).
    """
    from ..core.membudget import bucket_size
    from ..kernels.registry import workspace_bytes

    bls = sched.blocklists
    dense_mask = sched.dense_task_mask

    # ---- sparse items: (edge, k) pairs from sparse tasks --------------
    sg, lg, sb, lb = _sparse_items(store, bls, dense_mask)
    ids = _bucket_ids(lg) if lg.size else np.zeros(0, np.int64)
    buckets = []
    scratch = 0
    if plan is not None:
        for dp, steps in plan["dp_steps"]:
            sel = ids == (int(dp).bit_length() - 1)
            cnt = int(sel.sum())
            padded = bucket_size(cnt, minimum=1)
            # int32: positions index one wave's staged CSR slice
            arrs = {}
            for key, col in (("sg", sg), ("lg", lg), ("sb", sb), ("lb", lb)):
                a = np.zeros(padded, np.int32)
                a[:cnt] = col[sel]
                arrs[key] = a
            buckets.append(dict(dp=int(dp), steps=int(steps), **arrs))
            scratch += workspace_bytes("csr_bucket_search", items=padded, depth=int(dp))
    else:
        for b in np.unique(ids):
            sel = ids == b
            dp = int(2 ** b)
            buckets.append(dict(dp=dp, steps=_steps(lb[sel]),
                                sg=sg[sel], lg=lg[sel], sb=sb[sel], lb=lb[sel]))
            scratch += workspace_bytes("csr_bucket_search", items=int(sel.sum()), depth=dp)
    extras = {"tc_buckets": buckets, "tc_tiles_idx": None, "__workspace_bytes__": scratch}

    # ---- dense triples: tile index per block ---------------------------
    if dense_mask.any():
        tid_of_block = np.full(store.p * store.p, -1, np.int64)
        tid_of_block[store.tile_block_ids] = np.arange(store.tile_block_ids.size)
        triples = tid_of_block[bls[dense_mask]].astype(np.int32)
        if plan is not None:
            full = np.full((bucket_size(triples.shape[0], minimum=1), 3), -1, np.int32)
            full[: triples.shape[0]] = triples
            triples = full
        extras["tc_tiles_idx"] = triples
    return extras


def _mesh_pack(extras_list):
    """Unify per-wave ``_prepare`` outputs into one shape set, array
    leaves gaining a leading axis (one row per wave).

    The bucket ladders are data-dependent, so the union ladder is taken:
    a bucket absent from an entry contributes zero items, and item
    arrays pad to the per-bucket max with neutral items (``lg = lb =
    0``); ``steps`` takes the per-bucket max.  Dense triples pad with
    ``-1`` rows.  The returned tree re-declares ``__workspace_bytes__``
    for the unified shapes: every entry now runs every bucket at the
    padded count.
    """
    from ..kernels.registry import workspace_bytes

    d = len(extras_list)
    dps = sorted({int(b["dp"]) for e in extras_list for b in e["tc_buckets"]})
    buckets = []
    scratch = 0
    for dp in dps:
        per = [next((b for b in e["tc_buckets"] if int(b["dp"]) == dp), None)
               for e in extras_list]
        steps = max(int(b["steps"]) for b in per if b is not None)
        cnt = max((int(b["sg"].shape[0]) for b in per if b is not None), default=0) or 1
        arrs = {k: np.zeros((d, cnt), np.int64) for k in ("sg", "lg", "sb", "lb")}
        for i, b in enumerate(per):
            if b is None:
                continue
            for k in ("sg", "lg", "sb", "lb"):
                arrs[k][i, : b[k].shape[0]] = b[k]
        buckets.append(dict(dp=dp, steps=steps, **arrs))
        scratch += workspace_bytes("csr_bucket_search", items=cnt, depth=dp)
    out = {"tc_buckets": buckets, "__workspace_bytes__": scratch, "tc_tiles_idx": None}
    idxs = [e.get("tc_tiles_idx") for e in extras_list]
    if any(x is not None for x in idxs):
        tmax = max((x.shape[0] for x in idxs if x is not None), default=0) or 1
        stacked = np.full((d, tmax, 3), -1, np.int32)
        for i, x in enumerate(idxs):
            if x is not None:
                stacked[i, : x.shape[0]] = x
        out["tc_tiles_idx"] = stacked
    return out


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
    extents = (ctx.tile_rows, ctx.tile_cols)
    return dict(state, nt=state["nt"] + tc_tiles(ctx.tiles, idx, extents))


def tc_algorithm() -> BlockAlgorithm:
    return BlockAlgorithm(
        name="triangle_counting",
        mode=Mode.PATTERN,
        blocklist_size=3,
        make_blocklists=_make_blocklists,
        kernel_sparse=_kernel_sparse,
        kernel_dense=_kernel_dense,
        prepare=_prepare,
        stage_plan=_stage_plan,
        mesh_pack=_mesh_pack,
        init_state=lambda store: dict(nt=np.int64(0)),
        max_iterations=1,
        finalize=lambda store, state: int(state["nt"]),
        # csr="slice": the membership test reads ctx.indices, with every
        # position computed by _prepare from the (per-wave rebased)
        # row_block_ptr — so each streamed wave stages only the
        # conformal CSR row ranges its triples touch.  mesh="shard":
        # triples partition cleanly over shards (each triple's count is
        # independent and sums), with mesh_pack unifying the
        # data-dependent bucket ladders across shards
        metadata=dict(combine="add", workspace_kernel="tc_tiles", csr="slice",
                      mesh="shard"),
    )


def triangle_count(g: Graph, p: int = 8, **plan_kw) -> int:
    """End-to-end TC: degree order → DAG orient → block store → plan."""
    from ..core.engine import compile_plan

    dag = orient_dag(g)
    store = build_block_store(dag, p)
    return compile_plan(tc_algorithm(), store, **plan_kw).run().result
