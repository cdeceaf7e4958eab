"""Carry a graph store and an algorithm state across from numpy fields.

For this system the "weights" are the data: a partitioned graph and the
state of a run.  :func:`store_from_numpy` rebuilds the port's
:class:`~repro_torch.core.blocks.BlockStore` from the plain numpy fields
of a block store (the JAX package's ``BlockStore`` has the same
fields), and :func:`state_from_numpy` puts an algorithm state on a
device.  Tests use both to run the two packages on one store and to
step both from one mid-run state.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.blocks import BlockStore
from .core.context import to_device
from .core.graph import Graph
from .core.partition import layout_from_cuts

__all__ = ["STORE_FIELDS", "TILE_FIELDS", "store_from_numpy", "state_from_numpy"]

#: arrays every store carries (``cuts`` is the layout's cut vector)
STORE_FIELDS = ("src", "dst", "edge_block", "block_ptr", "indptr", "indices",
                "row_block_ptr", "cuts")
#: the dense tiles and their origins, present once tiles were materialized
TILE_FIELDS = ("tile_block_ids", "tiles", "tile_row_start", "tile_col_start")


def store_from_numpy(fields: Mapping[str, Any], *, directed: bool = False,
                     name: str = "graph") -> BlockStore:
    """A :class:`BlockStore` from the numpy arrays named in
    :data:`STORE_FIELDS` (and, optionally, :data:`TILE_FIELDS`).

    The arrays are copied with their dtypes kept; the layout is rebuilt
    from ``cuts`` and the graph from ``indptr``/``indices``.
    """
    missing = [k for k in STORE_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"store_from_numpy: missing fields {missing}")
    a = {k: np.array(fields[k]) for k in STORE_FIELDS}
    graph = Graph(indptr=a["indptr"], indices=a["indices"],
                  n=int(a["indptr"].shape[0]) - 1, directed=directed, name=name)
    store = BlockStore(
        graph=graph, layout=layout_from_cuts(graph, a["cuts"]),
        **{k: a[k] for k in STORE_FIELDS if k != "cuts"})
    if any(k in fields for k in TILE_FIELDS):
        for k in TILE_FIELDS:
            setattr(store, k, np.array(fields[k]))
        store.tile_dim = int(store.tiles.shape[-1])
    return store


def state_from_numpy(state: Mapping[str, Any],
                     device: "str | torch.device") -> dict:
    """An algorithm state (a dict of arrays or scalars) as tensors on
    ``device``, dtypes kept."""
    return to_device({k: np.asarray(v) for k, v in state.items()},
                     torch.device(device))
