"""The six-functor algorithm specification (paper §3, Listing 1).

A ``BlockAlgorithm`` is PGAbB's user contract:

=============== =================================================
paper functor    field
=============== =================================================
``K_H``          ``kernel_sparse(ctx, state, it) -> state``  (edge path)
``K_D``          ``kernel_dense(ctx, state, it) -> state``   (tile path)
``P_C``/``P_G``  ``make_blocklists(store) -> np.ndarray``  /
                 ``blocklist_predicate(store, blocklist) -> bool``
``I_B``          ``before(host, state, it) -> state``   (host side)
``I_A``          ``after(host, state, it) -> (state, bool)`` — iterate while True
``E``            ``estimate(store, blocklist) -> float``
=============== =================================================

At least one kernel must be provided (paper: "One of them has to be
written").  ``state`` is a dict of global/vertex/edge attributes
(paper: A_G / A_V / A_E) held as torch tensors on the plan's device.
``mode`` declares the paper's execution-mode classification and drives
block-list composition defaults.

Kernels receive a :class:`~repro_torch.core.context.Context` (device
tensors, scalars, and the algorithm's ``prepare`` outputs under
``ctx.extras``); the host hooks ``before``/``after`` receive a
:class:`~repro_torch.core.context.HostCtx` (store, schedule, scalars).

Iteration contract (enforced by :meth:`repro_torch.core.engine.Plan.run`):
``I_B`` → step → ``I_A``, repeated.  When ``after`` is provided, the
loop continues while it returns ``True``, bounded by
``max_iterations``.  When ``after`` is *absent*, the loop runs exactly
``max_iterations`` iterations (default 1).

``metadata`` keys the in-core engine reads:

``params``
    step-affecting factory parameters — the step cache keys on
    ``(name, params, device type, direction)``.
``workspace_kernel`` / ``workspace_kernel_pull``
    registry kernel naming the dense path's scratch estimator.
``direction``
    push/pull capability: ``dict(frontier=<state leaf>, beta=...)``
    together with the ``kernel_sparse_pull``/``kernel_dense_pull``
    twins enables ``compile_plan(..., direction="pull" | "auto")`` —
    per-iteration direction optimization (:mod:`repro_torch.core.direction`).

The remaining keys (``combine``, ``csr``, ``mesh``, ``host``, ...) are
kept for parity with the reference package; the executors that read
them are not ported yet (see ``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

__all__ = ["BlockAlgorithm", "Mode", "default_estimate"]


class Mode:
    BULK = "single_block_bulk_synchronous"
    ACTIVATION = "activation_based"
    PATTERN = "multi_block_pattern_based"


def default_estimate(store, blocklist: np.ndarray) -> float:
    """Paper default E: total number of edges within the block-list."""
    bl = np.atleast_1d(np.asarray(blocklist, dtype=np.int64))
    return float(
        np.sum(store.block_ptr[bl + 1] - store.block_ptr[bl])
    )


@dataclass
class BlockAlgorithm:
    name: str
    mode: str = Mode.BULK
    # kernels — at least one required
    kernel_sparse: Callable[..., Any] | None = None   # K_H analog
    kernel_dense: Callable[..., Any] | None = None    # K_D analog
    # pull-direction twins (same signature/contract), read only when
    # metadata["direction"] declares the capability: a pull variant must
    # produce bit-identical int/bool results to its push twin from the
    # same iteration-start state on any edge sub-partition — the
    # executor substitutes one for the other per iteration (see
    # repro_torch.core.direction)
    kernel_sparse_pull: Callable[..., Any] | None = None
    kernel_dense_pull: Callable[..., Any] | None = None
    # block-list composition — P_C (explicit) or P_G (predicate)
    make_blocklists: Callable[..., np.ndarray] | None = None
    blocklist_predicate: Callable[..., bool] | None = None
    blocklist_size: int = 1
    # iteration control
    before: Callable[..., Any] | None = None          # I_B
    after: Callable[..., Any] | None = None           # I_A (required for iterative)
    max_iterations: int = 1
    # scheduling
    estimate: Callable[..., float] = default_estimate  # E
    # post-path combine, runs inside the step after both kernels
    # (e.g. PageRank applies damping once both paths accumulated)
    post: Callable[..., Any] | None = None
    # one-time extras preparation: (store, schedule) -> dict placed on
    # Context.extras (bucketed item arrays, tile index maps, ...).
    # When ``stage_plan`` is set, prepare is called with a third
    # positional argument: the plan-wide staging plan (see below).
    prepare: Callable[..., dict] | None = None
    # optional cross-wave staging plan: (store, schedule) -> Any, called
    # ONCE per *streaming* plan with the FULL store and schedule,
    # before any (wave- or device-restricted) ``prepare``.  Its result
    # is handed to every prepare call so shape-driving decisions — TC's
    # dp/steps bucket ladder — are made once for the whole plan instead
    # of per wave, keeping every wave's extras structurally identical
    # (one jit trace per distinct bucket shape, not one per wave).  The
    # in-core Plan passes ``plan=None`` instead: a single context needs
    # no shape stabilization, so prepare keeps its unpadded form there.
    stage_plan: Callable[..., Any] | None = None
    # mesh-cooperative streaming only: pack the per-device ``prepare``
    # outputs of one wave into a single extras tree whose array leaves
    # carry a leading device axis (sharded over the mesh; the leading
    # axis is stripped inside each shard) and whose non-array leaves
    # are device-invariant.  Required when per-device prepare outputs
    # differ in *structure* (TC's data-dependent bucket ladder); when
    # None, the executor stacks structurally identical outputs itself.
    # Padding must be neutral for the kernels — the framework cannot
    # know which sentinel is harmless.
    mesh_pack: Callable[..., dict] | None = None
    # initial attribute state factory: (store) -> dict of arrays
    init_state: Callable[..., Any] | None = None
    # extract final result: (store, state) -> anything
    finalize: Callable[..., Any] | None = None
    # free-form; factories record step-affecting parameters under
    # metadata["params"] so built steps are cached per (name, params)
    metadata: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kernel_sparse is None and self.kernel_dense is None:
            raise ValueError(
                f"{self.name}: at least one of kernel_sparse/kernel_dense is required"
            )

    def run_prepare(self, store, sched, plan: Any = None) -> dict:
        """Invoke ``prepare`` with the staging plan when one is declared.

        Algorithms without ``stage_plan`` keep the two-argument prepare
        contract unchanged; algorithms with one always receive the plan
        (``None`` only when a caller skipped :attr:`stage_plan` — e.g.
        ad-hoc use outside an executor)."""
        if self.prepare is None:
            return {}
        if self.stage_plan is not None:
            return self.prepare(store, sched, plan)
        return self.prepare(store, sched)

    def compose_blocklists(self, store) -> np.ndarray:
        """Run P_C, or enumerate + filter with P_G (paper §3)."""
        if self.make_blocklists is not None:
            bls = np.asarray(self.make_blocklists(store))
        else:
            nb = store.layout.num_blocks
            if self.blocklist_size == 1:
                cand = np.arange(nb, dtype=np.int64)[:, None]
            else:
                grids = np.meshgrid(
                    *[np.arange(nb, dtype=np.int64)] * self.blocklist_size,
                    indexing="ij",
                )
                cand = np.stack([x.ravel() for x in grids], axis=1)
            if self.blocklist_predicate is not None:
                keep = np.fromiter(
                    (self.blocklist_predicate(store, row) for row in cand),
                    dtype=bool,
                    count=cand.shape[0],
                )
                cand = cand[keep]
            bls = cand
        if bls.ndim == 1:
            bls = bls[:, None]
        return bls.astype(np.int64)
