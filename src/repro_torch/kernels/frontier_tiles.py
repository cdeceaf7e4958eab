"""Bottom-up BFS tile probe, BFS's dense pull (K_D) path.

For each row ``u`` of tile ``b``: the smallest local column ``c`` with
``A[b, u, c] > 0`` and ``fcols[b, c] > 0``, else ``INT32_MAX``.  Port of
the Pallas kernel ``repro/kernels/frontier_tile.py::frontier_tiles``,
with the query axis that ``vmap`` gives it under multi-source BFS:
``fcols (Q, nd, T)`` against the shared tiles is one launch.
The CUDA kernel is ``csrc/frontier_tiles.cu``; the plain version is
:func:`repro_torch.kernels.ref.frontier_tiles_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["frontier_tiles", "frontier_tiles_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FDTYPES = {torch.bool: 0, torch.float32: 1, torch.bfloat16: 2}
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def frontier_tiles(tiles: torch.Tensor, fcols: torch.Tensor, extents=None) -> torch.Tensor:
    """(nd, T, T) tiles × (nd, T) frontier columns → (nd, T) int32; with
    a query axis, ``fcols (Q, nd, T)`` → ``(Q, nd, T)``, row q equal to
    the call on ``fcols[q]``.

    ``extents=(rows, cols)``, two ``(nd,)`` int32 tensors, promises that
    tile ``b`` is zero at rows ≥ ``rows[b]`` and at columns ≥
    ``cols[b]``; the kernel does not read those entries (nor the
    frontier columns ≥ ``cols[b]``).  ``None`` means whole tiles.  The
    plain version ignores ``extents`` and reads whole tiles.

    Tensors on the CPU take the plain version; anything else launches
    the CUDA kernel, which raises for a tensor that is not on a card.
    """
    _build.check_extents("frontier_tiles", extents, tiles)
    if tiles.device.type == "cpu" and fcols.device.type == "cpu":
        return ref.frontier_tiles_ref(tiles, fcols, extents)
    return frontier_tiles_cuda(tiles, fcols, extents)


def frontier_tiles_cuda(tiles: torch.Tensor, fcols: torch.Tensor,
                        extents=None) -> torch.Tensor:
    """The CUDA kernel alone; counts its launches in ``.launches``."""
    dev = _build.require_cuda("frontier_tiles", tiles, fcols)
    if tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2]:
        raise ValueError(
            f"frontier_tiles: tiles must be (nd, T, T); got {tuple(tiles.shape)}")
    nd, t = tiles.shape[0], tiles.shape[1]
    if tuple(fcols.shape[-2:]) != (nd, t) or fcols.dim() not in (2, 3):
        raise ValueError(f"frontier_tiles: fcols must be ({nd}, {t}) or (Q, {nd}, {t}); "
                         f"got {tuple(fcols.shape)}")
    nq = fcols.shape[0] if fcols.dim() == 3 else 1
    if tiles.dtype not in _DTYPES:
        raise TypeError(f"frontier_tiles: tiles must be float32 or bfloat16; got {tiles.dtype}")
    if fcols.dtype not in _FDTYPES:
        raise TypeError(
            f"frontier_tiles: fcols must be bool, float32 or bfloat16; got {fcols.dtype}")
    rows, cols = _build.check_extents("frontier_tiles", extents, tiles)
    _build.require_contiguous("frontier_tiles", tiles, fcols,
                              *(e for e in (rows, cols) if e is not None))
    out = torch.empty(fcols.shape, dtype=torch.int32, device=dev)
    if nq == 0 or nd == 0 or t == 0:
        return out
    fn = _build.function("frontier_tiles", "frontier_tiles_launch", _ARGTYPES)
    err = fn(dev.index, tiles.data_ptr(), fcols.data_ptr(),
             None if rows is None else rows.data_ptr(),
             None if cols is None else cols.data_ptr(), out.data_ptr(), nq, nd, t,
             _DTYPES[tiles.dtype], _FDTYPES[fcols.dtype], _build.stream_handle(dev))
    _build.raise_on_error("frontier_tiles", err)
    frontier_tiles_cuda.launches += 1
    return out


frontier_tiles_cuda.launches = 0
