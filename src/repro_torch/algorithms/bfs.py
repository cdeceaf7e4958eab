"""Direction-optimized BFS (paper §3.5, Listings 3–4) — activation mode.

The paper implements top-down in K_H and bottom-up in K_D, choosing per
level.  The framework's push/pull direction capability
(:mod:`repro_torch.core.direction`) expresses that split:

* **push** (top-down): masked scatter over the segmented COO — every
  edge whose source is in the frontier offers itself as parent of an
  unvisited destination (``scatter_reduce_`` with ``amin`` picks a
  deterministic parent).  The dense-path twin runs the same scatter
  over the dense-routed edges.
* **pull** (bottom-up): for each unvisited vertex, find the smallest
  frontier neighbor.  The sparse twin is a reversed edge scatter; the
  dense twin probes the packed bitmap tiles with the ``frontier_tiles``
  kernel — the paper's Listing 3 "if one of its neighbors appears in
  the frontier, insert and stop".

``compile_plan(..., direction="auto")`` re-creates the paper's
per-level Beamer switch from the frontier count ``nf``.  Visitation is
judged on ``dist``, which only ``post`` writes, so every direction and
every split of a level's edges gives bit-identical parents.  A batched
multi-source state is not ported yet (ROADMAP A11).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.functors import BlockAlgorithm, Mode
from ..kernels.frontier_tiles import frontier_tiles

__all__ = ["bfs_algorithm", "bfs"]

_UNVISITED = 2**31 - 1  # parent/dist sentinel (INT32_MAX)


def _init_factory(source: int):
    def _init(store):
        n = store.n
        parent = np.full(n, _UNVISITED, np.int32)
        frontier = np.zeros(n, bool)
        dist = np.full(n, _UNVISITED, np.int32)
        parent[source], frontier[source], dist[source] = source, True, 0
        return dict(parent=parent, frontier=frontier, dist=dist, nf=np.int32(1))

    return _init


def _min_into(parent: torch.Tensor, tgt: torch.Tensor,
              cand: torch.Tensor) -> torch.Tensor:
    """``parent`` with ``cand`` min-scattered at ``tgt``; target ``n``
    is the padding slot that masked entries land in."""
    ppad = torch.cat([parent, parent.new_full((1,), _UNVISITED)])
    ppad.scatter_reduce_(0, tgt.reshape(-1).long(), cand.reshape(-1),
                         reduce="amin", include_self=True)
    return ppad[: parent.shape[0]]


def _top_down(ctx, state, edge_mask):
    src, dst = ctx.src, ctx.dst
    n = state["parent"].shape[0]
    unvisited = state["dist"] == _UNVISITED
    do = edge_mask & state["frontier"][src] & unvisited[dst]
    return _min_into(state["parent"], torch.where(do, dst, n),
                     torch.where(do, src, _UNVISITED))


def _bottom_up_edges(ctx, state, edge_mask):
    # reversed roles: unvisited src looks for any frontier dst neighbor.
    # On the symmetrized arc multiset this scatters the same
    # (target, candidate) pairs as _top_down — the pull contract.
    src, dst = ctx.src, ctx.dst
    n = state["parent"].shape[0]
    unvisited = state["dist"] == _UNVISITED
    do = edge_mask & unvisited[src] & state["frontier"][dst]
    return _min_into(state["parent"], torch.where(do, src, n),
                     torch.where(do, dst, _UNVISITED))


def _bottom_up_tiles(ctx, state):
    t = ctx.tile_dim
    parent = state["parent"]
    n = parent.shape[0]
    cols = torch.arange(t, device=parent.device)
    frontier = state["frontier"]
    fcols = torch.cat([frontier, frontier.new_zeros(t)])[ctx.tile_col_start[:, None] + cols]
    # per tile row: smallest local frontier column, else INT32_MAX
    cand_local = frontier_tiles(ctx.tiles, fcols)
    cand = torch.where(cand_local == _UNVISITED, _UNVISITED,
                       cand_local + ctx.tile_col_start[:, None])
    rows = (ctx.tile_row_start[:, None] + cols).clamp_max(n)  # rows past n pad
    unvisited_pad = torch.cat([state["dist"] == _UNVISITED,
                               torch.zeros(1, dtype=torch.bool, device=parent.device)])
    cand = torch.where(unvisited_pad[rows], cand, _UNVISITED)
    return _min_into(parent, rows, cand)


def _level_kernel(level_fn):
    """Lift a level function into a (ctx, state, it) kernel."""

    def kernel(ctx, state, it):
        if state["parent"].dim() != 1:
            raise NotImplementedError(
                "bfs: a batched (multi-source) state is not ported yet: ROADMAP A11")
        return dict(state, parent=level_fn(ctx, state))

    return kernel


_kernel_sparse = _level_kernel(
    lambda ctx, s: _top_down(ctx, s, ctx.sparse_edge_mask))
_kernel_dense = _level_kernel(
    lambda ctx, s: _top_down(ctx, s, ctx.dense_edge_mask))
_kernel_sparse_pull = _level_kernel(
    lambda ctx, s: _bottom_up_edges(ctx, s, ctx.sparse_edge_mask))
_kernel_dense_pull = _level_kernel(_bottom_up_tiles)


def _post(ctx, state, it):
    # new frontier = vertices visited this level
    newly = (state["dist"] == _UNVISITED) & (state["parent"] != _UNVISITED)
    dist = torch.where(newly, it + 1, state["dist"])
    nf = newly.sum(dtype=torch.int32)
    return dict(state, frontier=newly, dist=dist, nf=nf)


def bfs_algorithm(source: int = 0, *, sources=None, max_iters: int = 10_000,
                  beta: int = 24) -> BlockAlgorithm:
    """Single-source BFS from ``source``.

    ``beta`` is the Beamer cost ratio the direction controller applies
    under ``compile_plan(..., direction="auto")`` (pull once
    ``nf * beta > n``, hysteresis on the way back)."""
    if sources is not None:
        raise NotImplementedError(
            "bfs_algorithm(sources=...): batched multi-source BFS is not "
            "ported yet: ROADMAP A11")

    def after(host, state, it):
        return state, bool(np.any(state["nf"].cpu().numpy() > 0))

    return BlockAlgorithm(
        name="bfs",
        mode=Mode.ACTIVATION,
        kernel_sparse=_kernel_sparse,
        kernel_dense=_kernel_dense,
        kernel_sparse_pull=_kernel_sparse_pull,
        kernel_dense_pull=_kernel_dense_pull,
        post=_post,
        init_state=_init_factory(source),
        after=after,
        max_iterations=max_iters,
        finalize=lambda store, state: dict(
            parent=state["parent"].cpu().numpy(),
            dist=state["dist"].cpu().numpy(),
        ),
        metadata=dict(workspace_kernel="frontier_tiles",
                      workspace_kernel_pull="frontier_tiles",
                      direction=dict(frontier="nf", beta=float(beta))),
    )


def bfs(store, source: int = 0, **plan_kw) -> dict:
    from ..core.engine import compile_plan

    alg = bfs_algorithm(source, max_iters=plan_kw.pop("max_iters", 10_000),
                        beta=plan_kw.pop("beta", 24))
    return compile_plan(alg, store, **plan_kw).run().result
