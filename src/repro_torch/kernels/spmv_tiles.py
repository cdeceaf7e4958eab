"""Batched dense-tile SpMV, PageRank's dense (K_D) path: ``y[b] = A[b]ᵀ x[b]``.

Port of the Pallas kernel ``repro/kernels/spmv_tile.py::spmv_tiles``,
with the query axis that ``vmap`` gives it under batched PageRank:
``xs (Q, nd, T)`` against the shared tiles is one launch.
The CUDA kernel is ``csrc/spmv_tiles.cu`` (its header says what bounds
it and how it is laid out: a block per 256-column panel of each tile's
block rectangle, no atomics, no memset); the plain version is
:func:`repro_torch.kernels.ref.spmv_tiles_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["spmv_tiles", "spmv_tiles_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def spmv_tiles(tiles: torch.Tensor, xs: torch.Tensor, extents=None) -> torch.Tensor:
    """(nd, T, T) 0/1 tiles × (nd, T) slices → (nd, T) float32; with a
    query axis, ``xs (Q, nd, T)`` → ``(Q, nd, T)``, row q equal to the
    call on ``xs[q]``.

    ``extents=(rows, cols)``, two ``(nd,)`` int32 tensors, promises that
    tile ``b`` is zero at rows ≥ ``rows[b]`` and at columns ≥
    ``cols[b]``; the kernel does not read those entries (nor ``xs[b, r]``
    for ``r ≥ rows[b]``), and ``ys[b, c]`` is exactly 0 for every
    ``c ≥ cols[b]``.  ``None`` means whole tiles.  The plain version
    ignores ``extents`` and reads whole tiles.

    Tensors on the CPU take the plain version; anything else launches
    the CUDA kernel, which raises for a tensor that is not on a card.
    """
    _build.check_extents("spmv_tiles", extents, tiles)
    if tiles.device.type == "cpu" and xs.device.type == "cpu":
        return ref.spmv_tiles_ref(tiles, xs, extents)
    return spmv_tiles_cuda(tiles, xs, extents)


def spmv_tiles_cuda(tiles: torch.Tensor, xs: torch.Tensor, extents=None) -> torch.Tensor:
    """The CUDA kernel alone; counts its launches in ``.launches``."""
    dev = _build.require_cuda("spmv_tiles", tiles, xs)
    if tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2]:
        raise ValueError(f"spmv_tiles: tiles must be (nd, T, T); got {tuple(tiles.shape)}")
    nd, t = tiles.shape[0], tiles.shape[1]
    if tuple(xs.shape[-2:]) != (nd, t) or xs.dim() not in (2, 3):
        raise ValueError(
            f"spmv_tiles: xs must be ({nd}, {t}) or (Q, {nd}, {t}); got {tuple(xs.shape)}")
    nq = xs.shape[0] if xs.dim() == 3 else 1
    if tiles.dtype not in _DTYPES or xs.dtype != tiles.dtype:
        raise TypeError(f"spmv_tiles: tiles and xs must share float32 or bfloat16; "
                        f"got {tiles.dtype} and {xs.dtype}")
    rows, cols = _build.check_extents("spmv_tiles", extents, tiles)
    _build.require_contiguous("spmv_tiles", tiles, xs,
                              *(e for e in (rows, cols) if e is not None))
    # every element is written: sums below cols[b], zeros past it
    ys = torch.empty(xs.shape, dtype=torch.float32, device=dev)
    if nq == 0 or nd == 0 or t == 0:
        return ys
    # 16-byte loads where every row starts on a 16-byte boundary
    vec = (t * tiles.element_size()) % 16 == 0 and tiles.data_ptr() % 16 == 0
    fn = _build.function("spmv_tiles", "spmv_tiles_launch", _ARGTYPES)
    err = fn(dev.index, tiles.data_ptr(), xs.data_ptr(),
             None if rows is None else rows.data_ptr(),
             None if cols is None else cols.data_ptr(), ys.data_ptr(), nq, nd, t,
             _DTYPES[tiles.dtype], int(vec), _build.stream_handle(dev))
    _build.raise_on_error("spmv_tiles", err)
    spmv_tiles_cuda.launches += 1
    return ys


spmv_tiles_cuda.launches = 0
