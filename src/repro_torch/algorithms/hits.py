"""HITS (hubs & authorities) — single-block bulk-synchronous, next to
PageRank in paper Fig. 1.

a ← Aᵀh, h ← A·a, both L2-normalized.  The update is phase-split across
engine iterations (even: authority scatter, odd: hub scatter), with the
normalization in ``post``:

* **kernel** (K_H): one masked segmented-COO scatter-add into the
  ``acc`` scratch attribute — a pure edge-decomposable reduction, which
  lets the streaming executor fold per-wave partials with the declared
  ``add`` combine.
* **post**: L2-normalize ``acc`` into ``auth`` (even) / ``hub`` (odd),
  accumulate the L1 delta, reset ``acc``.

``delta`` carries the full |Δa|+|Δh| of one HITS iteration only after
the odd phase; ``after`` checks it there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.functors import BlockAlgorithm, Mode

__all__ = ["hits_algorithm", "hits"]


def _init(store):
    n = store.n
    v = np.full(n, 1.0 / np.sqrt(n), np.float32)
    return dict(hub=v, auth=v.copy(), acc=np.zeros(n, np.float32),
                delta_a=np.float32(0.0), delta=np.float32(np.inf))


def _kernel_sparse(ctx, state, it):
    src, dst, msk = ctx.src, ctx.dst, ctx.sparse_edge_mask
    if it % 2 == 0:   # authority phase: a[v] += h[u] over edges u→v
        acc = state["acc"].index_add(0, dst, torch.where(msk, state["hub"][src], 0.0))
    else:             # hub phase: h[u] += a[v]
        acc = state["acc"].index_add(0, src, torch.where(msk, state["auth"][dst], 0.0))
    return dict(state, acc=acc)


def _post(ctx, state, it):
    acc = state["acc"]
    new = acc / torch.linalg.vector_norm(acc).clamp_min(1e-12)
    if it % 2 == 0:
        return dict(state, auth=new, delta_a=(new - state["auth"]).abs().sum(),
                    acc=torch.zeros_like(acc))
    return dict(state, hub=new,
                delta=state["delta_a"] + (new - state["hub"]).abs().sum(),
                acc=torch.zeros_like(acc))


def hits_algorithm(*, tol: float = 1e-8, max_iters: int = 100) -> BlockAlgorithm:
    def after(host, state, it):
        if it % 2 == 0:
            return state, True  # always finish the iteration's hub phase
        return state, bool(state["delta"].item() > tol)

    return BlockAlgorithm(
        name="hits",
        mode=Mode.BULK,
        kernel_sparse=_kernel_sparse,
        post=_post,
        init_state=_init,
        after=after,
        max_iterations=2 * max_iters,
        finalize=lambda store, state: dict(hub=state["hub"].cpu().numpy(),
                                           auth=state["auth"].cpu().numpy()),
        metadata=dict(combine=dict(acc="add"), csr="none"),
    )


def hits(store, **plan_kw) -> dict:
    from ..core.engine import compile_plan

    return compile_plan(hits_algorithm(), store, mode="sparse_only",
                        **plan_kw).run().result
