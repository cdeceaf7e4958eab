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
every split of a level's edges gives bit-identical parents.

Batch axis (``sources=[...]``): the state carries a leading query axis
on ``parent``/``frontier``/``dist`` (and a per-query count ``nf``).  The
level kernels run every query in the same launches — one min-scatter
over the flattened rows, one ``frontier_tiles`` launch over the
``(Q, nd, T)`` frontier columns — and a solo state runs as a batch of
one.  Each row runs exactly the traversal its solo run would, so
batched results are bit-identical to single-source runs; the direction
decision is per iteration (the controller sums the batched ``nf``
against ``n`` per query).
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


def _init_multi_factory(sources):
    srcs = np.atleast_1d(np.asarray(sources, dtype=np.int64)).ravel()
    if srcs.size == 0:
        raise ValueError("sources must name at least one vertex")

    def _init(store):
        n = store.n
        if (srcs < 0).any() or (srcs >= n).any():
            raise ValueError(f"sources out of range for a graph with {n} vertices")
        b = srcs.size
        rows = np.arange(b)
        parent = np.full((b, n), _UNVISITED, np.int32)
        frontier = np.zeros((b, n), bool)
        dist = np.full((b, n), _UNVISITED, np.int32)
        parent[rows, srcs] = srcs.astype(np.int32)
        frontier[rows, srcs] = True
        dist[rows, srcs] = 0
        return dict(parent=parent, frontier=frontier, dist=dist,
                    nf=np.ones(b, np.int32))

    return _init


def _min_into(parent: torch.Tensor, tgt: torch.Tensor,
              cand: torch.Tensor) -> torch.Tensor:
    """``parent`` (Q, n) with ``cand`` (Q, ...) min-scattered at ``tgt``
    (broadcast against ``cand``); target ``n`` is each row's padding
    slot, for tile rows past the last vertex.  One scatter for the
    batch: row q's targets are offset by q·(n + 1) into the flattened
    rows.

    A masked edge keeps its own target and offers ``INT32_MAX``, which
    leaves the minimum unchanged: sending every masked edge to the
    padding slot instead queues all their atomic mins on one address (on
    the card, most of a level's 32 M arcs)."""
    q, n = parent.shape
    ppad = torch.cat([parent, parent.new_full((q, 1), _UNVISITED)], 1)
    off = (n + 1) * torch.arange(q, device=parent.device)
    flat = (tgt.long() + off.view((q,) + (1,) * (cand.dim() - 1))).expand(cand.shape)
    ppad.view(-1).scatter_reduce_(0, flat.reshape(-1), cand.reshape(-1),
                                  reduce="amin", include_self=True)
    return ppad[:, :n]


def _top_down(ctx, state, edge_mask):
    src, dst = ctx.src, ctx.dst
    unvisited = state["dist"] == _UNVISITED
    do = edge_mask & state["frontier"][:, src] & unvisited[:, dst]
    return _min_into(state["parent"], dst, torch.where(do, src, _UNVISITED))


def _bottom_up_edges(ctx, state, edge_mask):
    # reversed roles: unvisited src looks for any frontier dst neighbor.
    # On the symmetrized arc multiset this scatters the same
    # (target, candidate) pairs as _top_down — the pull contract.
    src, dst = ctx.src, ctx.dst
    unvisited = state["dist"] == _UNVISITED
    do = edge_mask & unvisited[:, src] & state["frontier"][:, dst]
    return _min_into(state["parent"], src, torch.where(do, dst, _UNVISITED))


def _bottom_up_tiles(ctx, state):
    t = ctx.tile_dim
    parent = state["parent"]
    q, n = parent.shape
    cols = torch.arange(t, device=parent.device)
    frontier = state["frontier"]
    fcols = torch.cat([frontier, frontier.new_zeros(q, t)], 1)[
        :, ctx.tile_col_start[:, None] + cols]
    # per (query, tile row): smallest local frontier column, else
    # INT32_MAX — one launch over fcols (Q, nd, T) for the whole batch
    cand_local = frontier_tiles(ctx.tiles, fcols, (ctx.tile_rows, ctx.tile_cols))
    cand = torch.where(cand_local == _UNVISITED, _UNVISITED,
                       cand_local + ctx.tile_col_start[:, None])
    rows = (ctx.tile_row_start[:, None] + cols).clamp_max(n)  # rows past n pad
    unvisited_pad = torch.cat([state["dist"] == _UNVISITED,
                               torch.zeros((q, 1), dtype=torch.bool, device=parent.device)], 1)
    cand = torch.where(unvisited_pad[:, rows], cand, _UNVISITED)
    return _min_into(parent, rows, cand)


#: the state leaves a level function reads; the kernels lift exactly
#: these to a leading query axis, so every other leaf passes through as
#: the same object (the streaming executor's per-wave fold relies on
#: that to tell written leaves from carried ones)
_LEVEL_KEYS = ("parent", "frontier", "dist")


def _level_kernel(level_fn):
    """Lift a level function over (Q, n) leaves into a (ctx, state, it)
    kernel; a solo (n,) state runs as a batch of one."""

    def kernel(ctx, state, it):
        shape = state["parent"].shape
        sub = {k: state[k] if len(shape) == 2 else state[k][None] for k in _LEVEL_KEYS}
        return dict(state, parent=level_fn(ctx, sub).view(shape))

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
    # (elementwise, so the same code serves (n,) and batched (Q, n)
    # states; nf is a scalar or one count per query)
    newly = (state["dist"] == _UNVISITED) & (state["parent"] != _UNVISITED)
    dist = torch.where(newly, it + 1, state["dist"])
    nf = newly.sum(-1, dtype=torch.int32)
    return dict(state, frontier=newly, dist=dist, nf=nf)


def bfs_algorithm(source: int = 0, *, sources=None, max_iters: int = 10_000,
                  beta: int = 24) -> BlockAlgorithm:
    """Single-source BFS from ``source``, or — with ``sources=[...]`` —
    a batched multi-source BFS whose state carries a leading query axis
    (one independent traversal per source; see module docstring).

    ``beta`` is the Beamer cost ratio the direction controller applies
    under ``compile_plan(..., direction="auto")`` (pull once
    ``nf * beta > n``, hysteresis on the way back)."""
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
        init_state=(_init_factory(source) if sources is None
                    else _init_multi_factory(sources)),
        after=after,
        max_iterations=max_iters,
        finalize=lambda store, state: dict(
            parent=state["parent"].cpu().numpy(),
            dist=state["dist"].cpu().numpy(),
        ),
        # combine: a level's parent min-scatter is judged on post-written
        # dist, so the streaming executor min-folds any split of its
        # edges; csr="none": no kernel reads the adjacency;
        # batch="query": the state may carry a leading query axis
        metadata=dict(combine=dict(parent="min", dist="min"), csr="none",
                      workspace_kernel="frontier_tiles",
                      workspace_kernel_pull="frontier_tiles",
                      direction=dict(frontier="nf", beta=float(beta)), batch="query"),
    )


def bfs(store, source: int = 0, *, sources=None, **plan_kw) -> dict:
    from ..core.engine import compile_plan

    alg = bfs_algorithm(source, sources=sources,
                        max_iters=plan_kw.pop("max_iters", 10_000),
                        beta=plan_kw.pop("beta", 24))
    return compile_plan(alg, store, **plan_kw).run().result
