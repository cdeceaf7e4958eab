"""Carry a graph store, an algorithm state and LM weights across from
numpy fields.

For the graph engine the "weights" are the data: a partitioned graph and
the state of a run.  :func:`store_from_numpy` rebuilds the port's
:class:`~repro_torch.core.blocks.BlockStore` from the plain numpy fields
of a block store (the JAX package's ``BlockStore`` has the same
fields), and :func:`state_from_numpy` puts an algorithm state on a
device.  :func:`lm_params_from_numpy` turns the JAX LM's parameter tree,
taken to numpy, into the port's :class:`~repro_torch.models.lm.LM`.
Tests use them to run the two packages on the same inputs.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.blocks import BlockStore
from .core.context import to_device
from .core.engine import resolve_device
from .core.graph import Graph
from .core.partition import layout_from_cuts
from .configs.base import ArchConfig
from .models.lm import LM

__all__ = ["STORE_FIELDS", "TILE_FIELDS", "store_from_numpy", "state_from_numpy",
           "lm_params_from_numpy"]

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
        store.tile_rows, store.tile_cols = store.tile_extents(store.tile_block_ids)
    return store


def state_from_numpy(state: Mapping[str, Any],
                     device: "str | torch.device") -> dict:
    """An algorithm state (a dict of arrays or scalars) as tensors on
    ``device``, dtypes kept."""
    return to_device({k: np.asarray(v) for k, v in state.items()},
                     torch.device(device))


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


def lm_params_from_numpy(cfg: ArchConfig, params: Mapping[str, Any],
                         device: "str | torch.device | None" = None) -> LM:
    """The port's :class:`LM` holding the weights of the reference's
    parameter tree ``params`` (nested dicts of numpy arrays, per-layer
    arrays stacked on a leading ``(L, ...)`` axis), on ``device``: by
    default the current card, raising where there is none unless the
    caller names the CPU.

    Each stacked array is split into the layers; ``(d_in, d_out)``
    orientation is kept.  Values go through float32 (exact for bfloat16
    both ways) and are cast to the parameter dtype of ``cfg``.
    """
    flat = _flatten(params)
    model = LM(cfg, device=resolve_device(device))
    used = set()
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":           # layers.<i>.attn.wq ← layers.attn.wq[i]
            key = ".".join(["layers", *parts[2:]])
            a = flat[key][int(parts[1])]
        else:
            key = name
            a = flat[key]
        used.add(key)
        a = np.asarray(a, dtype=np.float32)
        if a.shape != tuple(param.shape):
            raise ValueError(f"lm_params_from_numpy: {name} is {a.shape}, "
                             f"expected {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(param.dtype))
    if set(flat) - used:
        raise KeyError(f"lm_params_from_numpy: no place for {sorted(set(flat) - used)}")
    return model
