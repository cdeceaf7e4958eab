"""PageRank (paper §5.2.1) — single-block bulk-synchronous mode.

SpMV-style pull PageRank over the 2-D block layout.  Paper parameters:
damping 0.85, tolerance 1e-4, iteration limit 20.

* sparse path (K_H): masked segmented-COO scatter-add — every edge
  (u→v) deposits ``rank[u]/deg[u]`` into ``acc[v]`` with ``index_add``.
  On a card the float adds are atomic, so their order, and the last
  bits of ``rank``, change from run to run.
* dense path (K_D): the rank slices of the tile rows are gathered and
  the packed bitmap tiles contract against them in the ``spmv_tiles``
  kernel — ``acc[c0:c0+T] += A_bᵀ @ x[r0:r0+T]`` batched over tiles.
* post: damping + dangling mass + L1 delta, acc reset (runs once after
  both paths — the bulk-synchronous combine).

Personalization (``seeds=``): the restart vector ``r`` replaces the
uniform ``1/n`` teleport — mass ``1/len(seeds)`` at each seed, and
dangling mass is likewise redistributed over the seeds.  A batched
state (a leading query axis) is not ported yet (ROADMAP A11).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.functors import BlockAlgorithm, Mode
from ..kernels.spmv_tiles import spmv_tiles

__all__ = ["pagerank_algorithm", "pagerank"]


def _prepare(store, sched):
    return dict(
        inv_deg=1.0 / np.maximum(store.degrees, 1).astype(np.float32),
        dangling=store.degrees == 0,
    )


def _restart_vector(n: int, seeds) -> np.ndarray:
    s = np.atleast_1d(np.asarray(seeds, dtype=np.int64)).ravel()
    if s.size == 0:
        raise ValueError("seeds must name at least one vertex")
    if (s < 0).any() or (s >= n).any():
        raise ValueError(f"seeds out of range for a graph with {n} vertices")
    r = np.zeros(n, np.float32)
    np.add.at(r, s, np.float32(1.0 / s.size))
    return r


def _init_factory(seeds):
    def _init(store):
        n = store.n
        base = dict(acc=np.zeros(n, np.float32), delta=np.float32(np.inf))
        if seeds is None:
            return dict(base, rank=np.full(n, 1.0 / n, np.float32))
        r = _restart_vector(n, seeds)
        return dict(base, rank=r, restart=r)

    return _init


def _single(rank: torch.Tensor) -> None:
    if rank.dim() != 1:
        raise NotImplementedError(
            "pagerank: a batched (query-axis) state is not ported yet: ROADMAP A11")


def _kernel_sparse(ctx, state, it):
    _single(state["rank"])
    contrib = state["rank"] * ctx.extras["inv_deg"]
    vals = torch.where(ctx.sparse_edge_mask, contrib[ctx.src], 0.0)
    return dict(state, acc=state["acc"].index_add(0, ctx.dst, vals))


def _kernel_dense(ctx, state, it):
    _single(state["rank"])
    t = ctx.tile_dim
    acc = state["acc"]
    n = acc.shape[0]
    contrib = state["rank"] * ctx.extras["inv_deg"]
    cols = torch.arange(t, device=acc.device)
    xs = torch.cat([contrib, contrib.new_zeros(t)])[ctx.tile_row_start[:, None] + cols]
    ys = spmv_tiles(ctx.tiles, xs)                              # (nd, T)
    idx = (ctx.tile_col_start[:, None] + cols).reshape(-1)
    acc_pad = torch.cat([acc, acc.new_zeros(t)]).index_add_(0, idx, ys.reshape(-1))
    return dict(state, acc=acc_pad[:n])


def _post(ctx, state, it, damping=0.85):
    rank = state["rank"]
    n = rank.shape[0]
    dangling_mass = torch.where(ctx.extras["dangling"], rank, 0.0).sum()
    if "restart" in state:
        # teleport (and dangling) mass goes to the restart distribution
        # instead of 1/n — matches networkx's personalization + dangling
        r = state["restart"]
        new_rank = (1.0 - damping) * r + damping * (state["acc"] + dangling_mass * r)
    else:
        new_rank = (1.0 - damping) / n + damping * (state["acc"] + dangling_mass / n)
    delta = (new_rank - rank).abs().sum()
    return dict(state, rank=new_rank, acc=torch.zeros_like(state["acc"]), delta=delta)


def pagerank_algorithm(*, damping: float = 0.85, tol: float = 1e-4,
                       max_iters: int = 20, seeds=None) -> BlockAlgorithm:
    def post(ctx, state, it):
        return _post(ctx, state, it, damping)

    def after(host, state, it):
        return state, bool(np.any(state["delta"].cpu().numpy() > tol))

    return BlockAlgorithm(
        name="pagerank",
        mode=Mode.BULK,
        kernel_sparse=_kernel_sparse,
        kernel_dense=_kernel_dense,
        post=post,
        prepare=_prepare,
        init_state=_init_factory(seeds),
        after=after,
        max_iterations=max_iters,
        finalize=lambda store, state: state["rank"].cpu().numpy(),
        # seeds stay out of params: personalization is state content
        # (the restart leaf), so every seed set shares one step
        metadata=dict(params=dict(damping=damping, tol=tol),
                      workspace_kernel="spmv_tiles"),
    )


def pagerank(store, **plan_kw) -> np.ndarray:
    """Convenience wrapper: compile + run PageRank on a BlockStore."""
    from ..core.engine import compile_plan

    alg = pagerank_algorithm(
        damping=plan_kw.pop("damping", 0.85),
        tol=plan_kw.pop("tol", 1e-4),
        max_iters=plan_kw.pop("max_iters", 20),
        seeds=plan_kw.pop("seeds", None),
    )
    return compile_plan(alg, store, **plan_kw).run().result
