"""Connected components via Afforest (paper §5.2.3, Sutton et al. [54]).

1. **Neighbor-rounds sampling** (first ``k`` rounds): round ``r`` hooks
   every vertex to its ``r``-th neighbor.
2. **Skip detection** (host, I_B): sample vertices, find the most common
   component ``c_skip`` — the giant component.
3. **Finalization**: SV-style hooking over all edges *except* those whose
   endpoints already sit in ``c_skip``, repeated with compression until
   no hooks fire.

The kernel does *only* the hook — a min-decomposable scatter, so the
streaming executor folds per-wave partials exactly — while pointer
jumping (compression, one flag read back per round) and the hook
counter ``H`` live in ``post``, which runs once per iteration on the
combined state.  ``C_prev`` (stashed by I_B) is the iteration-start
snapshot ``post`` diffs against.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.functors import BlockAlgorithm, Mode
from .sv import hook, pointer_jump

__all__ = ["afforest_algorithm", "connected_components"]


def _init(store):
    n = store.n
    return dict(C=np.arange(n, dtype=np.int32), C_prev=np.arange(n, dtype=np.int32),
                H=np.int32(0), c_skip=np.int32(-1))


def _make_kernel(k_rounds: int, pull: bool = False):
    def kernel(ctx, state, it):
        C = state["C"]
        if it < k_rounds:
            # sampling: each vertex hooks to its it-th neighbor, read from
            # its own CSR row — no orientation to flip, shared by push and
            # pull.  The streaming executor swaps the first-k prefix CSR in
            n = C.shape[0]
            u = torch.arange(n, dtype=torch.int32, device=C.device)
            if ctx.indices.shape[0] == 0:
                return state
            idx = (ctx.indptr[:-1] + it).clamp_max(ctx.indices.shape[0] - 1)
            return dict(state, C=hook(C, u, ctx.indices[idx], it < ctx.degrees))
        # the skip predicate and the root-normalizing hook are both
        # endpoint-symmetric, so the pull orientation (reversed arcs)
        # min-folds to bit-identical C on the symmetrized arc multiset
        src, dst = (ctx.dst, ctx.src) if pull else (ctx.src, ctx.dst)
        skip = (C[src] == state["c_skip"]) & (C[dst] == state["c_skip"])
        return dict(state, C=hook(C, src, dst, ctx.sparse_edge_mask & ~skip))

    return kernel


def _post(ctx, state, it):
    hooked = (state["C"] != state["C_prev"]).sum(dtype=torch.int32)
    return dict(state, C=pointer_jump(state["C"]), H=hooked)


def afforest_algorithm(*, k_rounds: int = 2, sample_size: int = 1024,
                       max_iters: int = 200) -> BlockAlgorithm:
    def before(host, state, it):
        state = dict(state, C_prev=state["C"])  # iteration-start snapshot
        if it == k_rounds:  # I_B: detect the giant component once
            C = state["C"].cpu().numpy()
            n = C.shape[0]
            rng = np.random.default_rng(0)
            samp = C[rng.integers(0, n, min(sample_size, n))]
            vals, counts = np.unique(samp, return_counts=True)
            state = dict(state, c_skip=torch.tensor(
                int(vals[np.argmax(counts)]), dtype=torch.int32, device=host.device))
        return state

    def after(host, state, it):
        if it < k_rounds:
            return state, True
        return state, bool(state["H"].item() > 0)

    return BlockAlgorithm(
        name="afforest",
        mode=Mode.BULK,
        kernel_sparse=_make_kernel(k_rounds),
        kernel_sparse_pull=_make_kernel(k_rounds, pull=True),
        post=_post,
        init_state=_init,
        before=before,
        after=after,
        max_iterations=max_iters,
        finalize=lambda store, state: state["C"].cpu().numpy(),
        metadata=dict(
            combine=dict(C="min", C_prev="min", H="add", c_skip="max"),
            params=dict(k_rounds=k_rounds),
            # H counts hooks per round — high right after sampling
            # (pull), decaying as finalization converges (push)
            direction=dict(frontier="H"),
            # sampling rounds read only each vertex's first k_rounds
            # neighbors — the streaming executor runs one representative
            # wave for them against the first-k prefix CSR
            edge_free_iterations=k_rounds,
            csr="none",
        ),
    )


def connected_components(store, **plan_kw) -> np.ndarray:
    from ..core.engine import compile_plan

    return compile_plan(afforest_algorithm(), store, **plan_kw).run().result
