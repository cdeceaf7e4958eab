"""Shiloach–Vishkin connected components (paper §3.4, Listing 2).

Bulk-synchronous mode; iterations alternate Hook → Link exactly as the
paper's design ("during the even iterations we do the hooking and during
the odd iterations we do the linking").

* **Hook** (even ``it``): for every edge, if the roots of the endpoints
  differ, hook the greater root onto the smaller.  The paper's guarded
  CAS loop becomes a race-free min-scatter (``scatter_reduce_`` with
  ``amin``) applied only where the greater endpoint is a root.  ``H``
  counts changes.
* **Link** (odd ``it``): pointer jumping ``C[u] ← C[C[u]]`` to a
  fixpoint.  Each round reads one flag back from the device; the rounds
  are counted in the ``pointer_jump.rounds`` metric.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..core.functors import BlockAlgorithm, Mode

__all__ = ["sv_algorithm", "shiloach_vishkin", "hook", "pointer_jump"]


def hook(C: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
         do: torch.Tensor) -> torch.Tensor:
    """``C`` with the greater root of each ``do`` pair (u, v) hooked onto
    the smaller; target ``n`` is the padding slot masked pairs land in."""
    n = C.shape[0]
    cu, cv = C[u], C[v]
    r1 = torch.maximum(cu, cv)
    r2 = torch.minimum(cu, cv)
    do = do & (r1 != r2) & (C[r1] == r1)
    tgt = torch.where(do, r1, n).long()
    cp = torch.cat([C, C.new_full((1,), n)])
    return cp.scatter_reduce_(0, tgt, r2, reduce="amin", include_self=True)[:n]


def pointer_jump(C: torch.Tensor) -> torch.Tensor:
    """``C[u] ← C[C[u]]`` until nothing changes: one device→host read of
    a flag per round."""
    rounds = obs.metrics.counter("pointer_jump.rounds")
    while True:
        jumped = C[C]
        rounds.inc()
        if not bool((jumped != C).any()):
            return C
        C = jumped


def _init(store):
    return dict(C=np.arange(store.n, dtype=np.int32), H=np.int32(0))


def _hooked(state, C_new):
    return dict(C=C_new, H=state["H"] + (C_new != state["C"]).sum(dtype=torch.int32))


def _kernel_sparse(ctx, state, it):
    if it % 2:
        return dict(C=pointer_jump(state["C"]), H=state["H"])
    return _hooked(state, hook(state["C"], ctx.src, ctx.dst, ctx.sparse_edge_mask))


def _kernel_sparse_pull(ctx, state, it):
    # pull orientation: each vertex inspects its reversed arcs.  The hook
    # normalizes both endpoints through max/min before scattering, so on
    # the symmetrized arc multiset the min-fold lands bit-identical C
    if it % 2:
        return dict(C=pointer_jump(state["C"]), H=state["H"])
    return _hooked(state, hook(state["C"], ctx.dst, ctx.src, ctx.sparse_edge_mask))


def sv_algorithm(*, max_iters: int = 200) -> BlockAlgorithm:
    def before(host, state, it):
        if it % 2 == 0:  # I_B: reset H before each hooking iteration
            state = dict(state, H=torch.zeros((), dtype=torch.int32, device=host.device))
        return state

    def after(host, state, it):
        if it % 2 == 0:
            return state, True  # always follow a hook with a link
        # I_A after the link: continue iff the preceding hook did work
        return state, bool(state["H"].item() > 0)

    return BlockAlgorithm(
        name="shiloach_vishkin",
        mode=Mode.BULK,
        kernel_sparse=_kernel_sparse,
        kernel_sparse_pull=_kernel_sparse_pull,
        init_state=_init,
        before=before,
        after=after,
        max_iterations=max_iters,
        finalize=lambda store, state: state["C"].cpu().numpy(),
        metadata=dict(combine=dict(C="min", H="add"),
                      # H counts hooks: large early (pull), tapering to
                      # zero as components settle (back to push)
                      direction=dict(frontier="H"),
                      csr="none"),
    )


def shiloach_vishkin(store, **plan_kw) -> np.ndarray:
    from ..core.engine import compile_plan

    return compile_plan(sv_algorithm(), store, **plan_kw).run().result
