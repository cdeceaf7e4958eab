"""Carry a graph store, an algorithm state and LM weights across from
numpy fields.

For the graph engine the "weights" are the data: a partitioned graph and
the state of a run.  :func:`store_from_numpy` rebuilds the port's
:class:`~repro_torch.core.blocks.BlockStore` from the plain numpy fields
of a block store (the JAX package's ``BlockStore`` has the same
fields), and :func:`state_from_numpy` puts an algorithm state on a
device.  :func:`lm_params_from_numpy` turns the JAX LM's parameter tree,
taken to numpy, into the port's :class:`~repro_torch.models.lm.LM`, and
:func:`lm_params_to_numpy` carries it back; :func:`opt_state_to_numpy`
and :func:`opt_state_from_numpy` do the same for an optimizer state
(``mu``, ``nu``, ``count``).  Tests use them to run the two packages on
the same inputs and compare their states; the port's ``TrainLoop``
writes its checkpoints in this layout, so either package resumes the
other's.  A model sharded over a mesh (``models.steps.shard_model``) is
gathered whole on the way out (every rank takes part; ``keep=False`` on
a rank that writes nothing keeps none of it); on the way in,
:func:`stacked_layout` says where each stacked array goes, so that
``checkpoint.restore_checkpoint(..., shardings=)`` places it shard by
shard and the loaders copy each rank's shards, so a checkpoint moves
between one device and any mesh.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from .core.blocks import BlockStore
from .core.context import to_device
from .core.engine import resolve_device
from .core.graph import Graph
from .core.partition import layout_from_cuts
from .configs.base import ArchConfig
from .models.lm import LM

__all__ = ["STORE_FIELDS", "TILE_FIELDS", "store_from_numpy", "state_from_numpy",
           "lm_params_from_numpy", "lm_params_to_numpy", "load_lm_params",
           "opt_state_to_numpy", "opt_state_from_numpy", "stacked_layout"]

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


#: module lists of :class:`LM` that the reference stacks on a leading axis
STACKS = ("layers", "xattn", "encoder", "dec_xattn")


def _stacked_key(name: str, cfg: ArchConfig) -> tuple[str, Any]:
    """A parameter name of :class:`LM` as (key of the reference's flattened
    tree, index into its stacked array or None): ``layers.<i>.attn.wq`` →
    (``layers.attn.wq``, i), and for the vlm family, whose ``layers`` the
    reference stacks ``(n_groups, g, ...)``, (``layers.attn.wq``, (i // g,
    i % g)); likewise ``xattn.<k>``, ``encoder.<i>`` and ``dec_xattn.<i>``."""
    parts = name.split(".")
    if parts[0] in STACKS and len(parts) > 2 and parts[1].isdigit():
        i = int(parts[1])
        if parts[0] == "layers" and cfg.family == "vlm":
            i = divmod(i, cfg.cross_attn_every)
        return ".".join([parts[0], *parts[2:]]), i
    return name, None


def _nest(flat: Mapping[str, Any]) -> dict[str, Any]:
    """Dotted keys → nested dicts."""
    tree: dict[str, Any] = {}
    for key, a in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree


def _stack(cfg: ArchConfig, named: Mapping[str, torch.Tensor],
           keep: bool = True) -> dict[str, Any] | None:
    """Tensors keyed by parameter name → the reference's nested tree of
    float32 numpy arrays, per-layer arrays stacked on a leading L axis
    (``(n_groups, g)`` axes for the vlm's layers; exact for bfloat16).
    A sharded tensor is gathered whole (a collective: every rank of its
    mesh must call this); with ``keep=False`` nothing is kept and the
    result is None."""
    flat: dict[str, Any] = {}
    for name, t in named.items():
        key, index = _stacked_key(name, cfg)
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if not keep:
            continue
        a = t.detach().float().cpu().numpy()
        if index is None:
            flat[key] = a
        else:
            flat.setdefault(key, []).append((index, a))
    if not keep:
        return None
    for key, a in flat.items():
        if isinstance(a, list):
            a.sort(key=lambda p: p[0])
            last = a[-1][0]
            stacked = np.stack([x for _, x in a])
            grid = tuple(i + 1 for i in last) if isinstance(last, tuple) else (last + 1,)
            flat[key] = stacked.reshape(grid + stacked.shape[1:])
    return _nest(flat)


def stacked_layout(cfg: ArchConfig, named: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """The reference's stacked tree of the tensors ``named`` as a
    checkpoint restore takes it, with no data: ``(template, shardings)``,
    the template's leaves each stacked array's ``torch.dtype`` (its
    tensors'), and ``shardings``' its ``(mesh, placements)`` where the
    tensors are DTensors (their placements, each ``Shard`` moved past the
    stack dims), else None.  Restored with both
    (``checkpoint.restore_checkpoint(dir, template, shardings=...)``), a
    tree loads into the tensors (:func:`load_lm_params`,
    :func:`opt_state_from_numpy`) with each rank holding its shards only."""
    dtypes: dict[str, Any] = {}
    where: dict[str, Any] = {}
    for name, t in named.items():
        key, index = _stacked_key(name, cfg)
        depth = 0 if index is None else len(index) if isinstance(index, tuple) else 1
        sharding = None
        if isinstance(t, DTensor):
            if any(isinstance(pl, Shard) and type(pl) is not Shard for pl in t.placements):
                raise NotImplementedError(f"{name}: placements {t.placements} are not "
                                          "Shard/Replicate")
            sharding = (t.device_mesh, tuple(Shard(pl.dim + depth) if isinstance(pl, Shard)
                                             else pl for pl in t.placements))
        if where.setdefault(key, sharding) != sharding or \
                dtypes.setdefault(key, t.dtype) != t.dtype:
            raise ValueError(f"{name}: its layer's placement or dtype differs from the "
                             f"others stacked in {key}")
    return _nest(dtypes), _nest(where)


def _unstack_into(cfg: ArchConfig, targets: Mapping[str, torch.Tensor],
                  tree: Mapping[str, Any], what: str) -> None:
    """Copy the reference's stacked tree ``tree`` into the tensors
    ``targets`` (keyed by parameter name), each cast to its dtype.  A
    leaf of ``tree`` may be an array or a tensor; a DTensor target takes
    a DTensor leaf with its placements (see :func:`stacked_layout`),
    each rank copying its own shard."""
    flat = _flatten(tree)
    used = set()
    with torch.no_grad():
        for name, t in targets.items():
            key, index = _stacked_key(name, cfg)
            src = flat[key]
            if not isinstance(src, torch.Tensor):
                src = np.asarray(src, dtype=np.float32)
                # ascontiguousarray makes a 0-d array (a gate) 1-d: keep its shape
                src = flat[key] = torch.from_numpy(np.ascontiguousarray(src).reshape(src.shape))
            used.add(key)
            if isinstance(t, DTensor) and not isinstance(src, DTensor):
                raise TypeError(f"{what}: {name} is sharded; restore the checkpoint placed "
                                "(restore_checkpoint(..., shardings=stacked_layout(...)[1]))")
            if index is not None:
                src = src[index]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{what}: {name} is {tuple(src.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
    if set(flat) - used:
        raise KeyError(f"{what}: no place for {sorted(set(flat) - used)}")


def lm_params_to_numpy(cfg: ArchConfig, model: LM, *, keep: bool = True) -> dict | None:
    """The reference's parameter tree of ``model``'s weights: nested dicts
    of float32 numpy arrays (exact for bfloat16), per-layer arrays
    stacked on a leading ``(L, ...)`` axis (the vlm's ``layers`` on
    ``(n_groups, g, ...)``), ``(d_in, d_out)`` kept.  Sharded weights are gathered whole (every
    rank of the mesh calls this); with ``keep=False`` (a rank that writes
    nothing) none of it is kept and the result is None."""
    return _stack(cfg, dict(model.named_parameters()), keep)


def load_lm_params(cfg: ArchConfig, model: LM, params: Mapping[str, Any]) -> LM:
    """Copy the reference's parameter tree ``params`` into ``model`` in
    place (the inverse of :func:`lm_params_to_numpy`); returns ``model``."""
    _unstack_into(cfg, dict(model.named_parameters()), params, "lm_params_from_numpy")
    return model


def opt_state_to_numpy(cfg: ArchConfig, state: Mapping[str, Any], *,
                       keep: bool = True) -> dict | None:
    """An optimizer state of :mod:`repro_torch.optim` (``mu``/``nu`` or
    ``mom`` keyed by parameter name, and ``count``) in the reference's
    layout: each moment as a stacked tree like the parameters', float32,
    and ``count`` a 0-d int32 array.  Sharded moments are gathered as
    :func:`lm_params_to_numpy` gathers weights, ``keep`` likewise."""
    out = {k: _stack(cfg, v, keep) if isinstance(v, Mapping) else
           np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                      dtype=np.int32)
           for k, v in state.items()}
    return out if keep else None


def opt_state_from_numpy(cfg: ArchConfig, state: Mapping[str, Any], model: LM) -> dict:
    """The reference's optimizer state ``state`` as the port's, for
    ``model``'s parameters: float32 moments keyed by parameter name on
    the model's device, ``count`` a 0-d int32 tensor there."""
    out: dict[str, Any] = {}
    for k, v in state.items():
        if isinstance(v, Mapping):
            moments = {name: torch.empty_like(p, dtype=torch.float32)
                       for name, p in model.named_parameters()}
            _unstack_into(cfg, moments, v, "opt_state_from_numpy")
            out[k] = moments
        else:
            out[k] = torch.tensor(int(np.asarray(v)), dtype=torch.int32, device=model.device)
    return out


def lm_params_from_numpy(cfg: ArchConfig, params: Mapping[str, Any],
                         device: "str | torch.device | None" = None) -> LM:
    """The port's :class:`LM` holding the weights of the reference's
    parameter tree ``params`` (nested dicts of numpy arrays, per-layer
    arrays stacked on a leading ``(L, ...)`` axis), on ``device``: by
    default the current card, raising where there is none unless the
    caller names the CPU.

    Each stacked array is split into the layers (the vlm's ``layers``
    from ``(n_groups, g, ...)``, its ``xattn`` from ``(n_groups, ...)``,
    the audio family's ``encoder`` and ``dec_xattn`` likewise; its
    ``enc_pos`` is not stacked); ``(d_in, d_out)`` orientation is kept,
    and so are the moe family's ``(L, E, d, f)`` expert stacks and the ssm
    family's two mixers in every layer.  Values
    go through float32 (exact for bfloat16 both ways) and are cast to
    each parameter's dtype: ``cfg``'s, except the parameters the
    reference keeps float32 under any config: the MoE ``router``, Mamba's
    ``a_log``, ``dt_bias`` and ``d_skip``, the mLSTM's and the sLSTM's
    ``wi``, ``wf``, ``bf`` and ``bi``, and the sLSTM's ``rz``.
    """
    return load_lm_params(cfg, LM(cfg, device=resolve_device(device)), params)
