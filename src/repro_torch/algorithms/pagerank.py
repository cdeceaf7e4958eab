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
dangling mass is likewise redistributed over the seeds.  The restart
vector lives in the state, so one step serves every seed set.

Batch axis: a state with a leading query axis (``rank`` of shape
``(Q, n)``, built with :func:`repro_torch.core.engine.batch_states`)
runs every query in the same launches: one ``index_add`` over the
flattened ``(Q·n)`` accumulator for the sparse path, one ``spmv_tiles``
launch over ``xs (Q, nd, T)`` for the dense path.  A solo state runs as
a batch of one.  Converged queries freeze — their rows stop updating
once ``delta <= tol`` — so each row ends with its solo run's state: bit
for bit on the CPU, where every per-row operation keeps the solo run's
order; within float tolerance on a card, whose ``index_add`` is atomic.
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


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a leading query axis: a solo (n,) state runs as one row."""
    return x if x.dim() == 2 else x[None]


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-query sums of a (Q, n) tensor, each taken as the solo run's 1-D
    sum: a (Q, n) reduction may split a row in another order, and the
    rows of a batch must end as their solo runs do."""
    return torch.stack([row.sum() for row in x.unbind(0)])


def _flat_index(idx: torch.Tensor, q: int, stride: int) -> torch.Tensor:
    """``idx`` (k,) repeated for q queries at offsets of ``stride``, as
    one flat (q·k,) index into a (q, stride) tensor, query-major; int32
    where every offset fits (the store's narrowed index type)."""
    dtype = idx.dtype if q * stride < 2**31 else torch.int64
    off = stride * torch.arange(q, device=idx.device, dtype=dtype)
    return (idx.to(dtype)[None] + off[:, None]).reshape(-1)


def _kernel_sparse(ctx, state, it):
    # one index_add over the flattened (Q·n) accumulator: query q's
    # contributions land at dst + q·n, after query q-1's, in edge order
    rank, acc = _rows(state["rank"]), _rows(state["acc"])
    q, n = acc.shape
    contrib = rank * ctx.extras["inv_deg"]
    vals = torch.where(ctx.sparse_edge_mask, contrib[:, ctx.src], 0.0)
    out = acc.reshape(-1).index_add(0, _flat_index(ctx.dst, q, n), vals.reshape(-1))
    return dict(state, acc=out.view(state["acc"].shape))


def _kernel_dense(ctx, state, it):
    t = ctx.tile_dim
    rank, acc = _rows(state["rank"]), _rows(state["acc"])
    q, n = acc.shape
    contrib = rank * ctx.extras["inv_deg"]
    cols = torch.arange(t, device=acc.device)
    xs = torch.cat([contrib, contrib.new_zeros(q, t)], 1)[:, ctx.tile_row_start[:, None] + cols]
    # (Q, nd, T): one launch for the whole batch; exactly 0 at columns
    # >= tile_cols, which index the next stripe
    ys = spmv_tiles(ctx.tiles, xs, (ctx.tile_rows, ctx.tile_cols))
    idx = _flat_index((ctx.tile_col_start[:, None] + cols).reshape(-1), q, n + t)
    acc_pad = torch.cat([acc, acc.new_zeros(q, t)], 1).reshape(-1)
    acc_pad = acc_pad.index_add_(0, idx, ys.reshape(-1)).view(q, n + t)
    return dict(state, acc=acc_pad[:, :n].reshape(state["acc"].shape))


def _post(ctx, state, it, damping=0.85):
    rank, acc = _rows(state["rank"]), _rows(state["acc"])
    n = rank.shape[1]
    dangling_mass = _row_sums(torch.where(ctx.extras["dangling"], rank, 0.0))[:, None]
    if "restart" in state:
        # teleport (and dangling) mass goes to the restart distribution
        # instead of 1/n — matches networkx's personalization + dangling
        r = _rows(state["restart"])
        new_rank = (1.0 - damping) * r + damping * (acc + dangling_mass * r)
    else:
        new_rank = (1.0 - damping) / n + damping * (acc + dangling_mass / n)
    delta = _row_sums((new_rank - rank).abs())
    shape = state["rank"].shape
    return dict(state, rank=new_rank.view(shape), acc=torch.zeros_like(state["acc"]),
                delta=delta.view(state["delta"].shape))


def pagerank_algorithm(*, damping: float = 0.85, tol: float = 1e-4,
                       max_iters: int = 20, seeds=None) -> BlockAlgorithm:
    def post(ctx, state, it):
        new = _post(ctx, state, it, damping)
        if state["rank"].dim() == 2:
            # freeze converged rows: a query whose previous delta is
            # already <= tol keeps the state its solo run ended with
            active = state["delta"] > tol
            for key in ("rank", "delta"):
                keep = active.view(active.shape + (1,) * (new[key].dim() - 1))
                new[key] = torch.where(keep, new[key], state[key])
        return new

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
        # (the restart leaf), so every seed set shares one step; tol
        # joins them because the batched post's freeze reads it
        # combine="add": the streaming executor folds each wave's acc
        # partial; csr="none": no kernel reads the adjacency;
        # batch="query": the state may carry a leading query axis
        # mesh="shard": the rank scatter decomposes over any edge
        # partition judged from iteration-start rank; acc folds as a sum
        # of the shards' deltas (up to float summation order)
        metadata=dict(combine="add", params=dict(damping=damping, tol=tol),
                      workspace_kernel="spmv_tiles", csr="none", mesh="shard",
                      batch="query"),
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
