"""Execution contexts: the device-side ``Context`` and the host-side
``HostCtx``.

* **``Context``** — everything a *kernel* may touch: the store's tensors
  on the plan's device, the static edge→path routing masks, the dense
  tiles, scalars (``n``, ``m``, ``p``, ``tile_dim``) and the algorithm's
  ``prepare`` outputs under ``extras``.  A plain dataclass: PyTorch runs
  eagerly, so nothing has to cross a tracing boundary.
* **``HostCtx``** — everything the *host-side hooks* (``I_B``/``I_A``)
  may touch: the ``BlockStore``, the ``Schedule``, and the same scalars.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover — import cycle guard, typing only
    from .blocks import BlockStore
    from .scheduler import Schedule

__all__ = ["Context", "HostCtx", "build_context", "build_host_ctx", "to_device"]


def to_device(tree: Any, device: torch.device) -> Any:
    """``tree`` with every numpy array or tensor leaf as a tensor on
    ``device`` (dtypes kept); dicts, lists and tuples are rebuilt and
    any other leaf (ints used as shapes, flags, None) is kept as is."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        a = np.asarray(tree)  # np.ascontiguousarray would lift 0-d to 1-d
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = a.copy()
        return torch.from_numpy(a).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


@dataclass(eq=False)
class Context:
    """Device-side inputs of one step; kernels read it by attribute."""

    # --- segmented COO + CSR views of the store -----------------------
    src: torch.Tensor
    dst: torch.Tensor
    edge_block: torch.Tensor
    indptr: torch.Tensor
    indices: torch.Tensor
    degrees: torch.Tensor
    row_block_ptr: torch.Tensor
    cuts: torch.Tensor
    # --- static path routing masks ------------------------------------
    sparse_edge_mask: torch.Tensor
    dense_edge_mask: torch.Tensor
    # --- dense bitmap tiles (None when the dense path is empty) -------
    tiles: torch.Tensor | None = None
    tile_row_start: torch.Tensor | None = None
    tile_col_start: torch.Tensor | None = None
    # --- per-algorithm prepare outputs --------------------------------
    extras: dict[str, Any] = field(default_factory=dict)
    # --- scalars -------------------------------------------------------
    n: int = 0
    m: int = 0
    p: int = 1
    tile_dim: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))


@dataclass
class HostCtx:
    """Host-side view handed to ``before``/``after`` hooks (I_B/I_A)."""

    store: "BlockStore"
    schedule: "Schedule"
    device: torch.device
    n: int
    m: int
    p: int
    tile_dim: int
    extras: dict[str, Any] = field(default_factory=dict)


def build_context(store: "BlockStore", schedule: "Schedule",
                  device: torch.device,
                  extras: dict[str, Any] | None = None) -> Context:
    """Assemble the :class:`Context` for one (store, schedule) on
    ``device``: the store's tensors, the edge→path routing masks derived
    from the schedule's dense selection, and the conformal cut vector."""
    arrays = store.to_device(device)
    dense_blocks = np.zeros(store.layout.num_blocks, dtype=bool)
    if schedule.dense_block_ids.size:
        dense_blocks[schedule.dense_block_ids] = True
    edge_dense = torch.from_numpy(dense_blocks[store.edge_block]).to(device)
    return Context(
        src=arrays["src"],
        dst=arrays["dst"],
        edge_block=arrays["edge_block"],
        indptr=arrays["indptr"],
        indices=arrays["indices"],
        degrees=arrays["degrees"],
        row_block_ptr=arrays["row_block_ptr"],
        cuts=arrays["cuts"],
        sparse_edge_mask=~edge_dense,
        dense_edge_mask=edge_dense,
        tiles=arrays.get("tiles"),
        tile_row_start=arrays.get("tile_row_start"),
        tile_col_start=arrays.get("tile_col_start"),
        extras=to_device(dict(extras or {}), device),
        n=store.n,
        m=store.m,
        p=store.p,
        tile_dim=schedule.tile_dim,
        device=device,
    )


def build_host_ctx(store: "BlockStore", schedule: "Schedule",
                   device: torch.device) -> HostCtx:
    return HostCtx(
        store=store,
        schedule=schedule,
        device=device,
        n=store.n,
        m=store.m,
        p=store.p,
        tile_dim=schedule.tile_dim,
    )
