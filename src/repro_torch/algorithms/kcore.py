"""k-core decomposition — activation-based peeling (paper Fig. 1 lists
peeling algorithms under activation-based execution).

Vertices whose alive-degree drops below k leave the subgraph, which
re-activates their neighbors' blocks.  The alive mask plays the
block-queue role; I_A stops when an iteration peels nobody.  The kernel
is a pure alive-degree scatter-add into the ``deg`` scratch attribute
(exactly add-decomposable across streamed waves); the ``deg >= k``
threshold, the peel counter and the scratch reset run once per
iteration in ``post`` — splitting them would let a vertex whose degree
is spread over several waves be peeled spuriously.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.functors import BlockAlgorithm, Mode

__all__ = ["kcore_algorithm", "k_core"]


def _init(store):
    n = store.n
    return dict(alive=np.ones(n, bool), deg=np.zeros(n, np.int32),
                peeled=np.int32(1))


def _alive_arcs(ctx, state):
    alive = state["alive"]
    return (ctx.sparse_edge_mask & alive[ctx.src] & alive[ctx.dst]).to(torch.int32)


def _kernel(ctx, state, it):
    return dict(state, deg=state["deg"].index_add(0, ctx.dst, _alive_arcs(ctx, state)))


def _kernel_pull(ctx, state, it):
    # pull orientation: each vertex accumulates over its out-arcs.  The
    # edge predicate is symmetric and the arc multiset is symmetrized,
    # so the add-fold lands bit-identical degrees
    return dict(state, deg=state["deg"].index_add(0, ctx.src, _alive_arcs(ctx, state)))


def _make_post(k: int):
    def post(ctx, state, it):
        alive = state["alive"]
        new_alive = alive & (state["deg"] >= k)
        return dict(alive=new_alive, deg=torch.zeros_like(state["deg"]),
                    peeled=(alive & ~new_alive).sum(dtype=torch.int32))

    return post


def kcore_algorithm(k: int, *, max_iters: int = 10_000) -> BlockAlgorithm:
    def after(host, state, it):
        return state, bool(state["peeled"].item() > 0)

    return BlockAlgorithm(
        name=f"kcore_{k}",
        mode=Mode.ACTIVATION,
        kernel_sparse=_kernel,
        kernel_sparse_pull=_kernel_pull,
        post=_make_post(k),
        init_state=_init,
        after=after,
        max_iterations=max_iters,
        finalize=lambda store, state: state["alive"].cpu().numpy(),
        metadata=dict(combine=dict(deg="add", alive="min", peeled="add"),
                      # nearly everything is alive early, so "auto" pulls
                      # until peeling thins the subgraph out
                      direction=dict(frontier="alive"),
                      csr="none"),
    )


def k_core(store, k: int, **plan_kw) -> np.ndarray:
    """Boolean membership mask of the k-core."""
    from ..core.engine import compile_plan

    return compile_plan(kcore_algorithm(k), store, mode="sparse_only",
                        **plan_kw).run().result
