"""Batched dense-tile SpMV, PageRank's dense (K_D) path: ``y[b] = A[b]ᵀ x[b]``.

Port of the Pallas kernel ``repro/kernels/spmv_tile.py::spmv_tiles``.
The CUDA kernel is ``csrc/spmv_tiles.cu`` (its header says what bounds
it and how it is laid out); the plain version is
:func:`repro_torch.kernels.ref.spmv_tiles_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["spmv_tiles", "spmv_tiles_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def spmv_tiles(tiles: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(nd, T, T) 0/1 tiles × (nd, T) slices → (nd, T) float32.

    Tensors on the CPU take the plain version; anything else launches
    the CUDA kernel, which raises for a tensor that is not on a card.
    """
    if tiles.device.type == "cpu" and xs.device.type == "cpu":
        return ref.spmv_tiles_ref(tiles, xs)
    return spmv_tiles_cuda(tiles, xs)


def spmv_tiles_cuda(tiles: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel alone; counts its launches in ``.launches``."""
    dev = _build.require_cuda("spmv_tiles", tiles, xs)
    if tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2]:
        raise ValueError(f"spmv_tiles: tiles must be (nd, T, T); got {tuple(tiles.shape)}")
    nd, t = tiles.shape[0], tiles.shape[1]
    if tuple(xs.shape) != (nd, t):
        raise ValueError(f"spmv_tiles: xs must be ({nd}, {t}); got {tuple(xs.shape)}")
    if tiles.dtype not in _DTYPES or xs.dtype != tiles.dtype:
        raise TypeError(f"spmv_tiles: tiles and xs must share float32 or bfloat16; "
                        f"got {tiles.dtype} and {xs.dtype}")
    _build.require_contiguous("spmv_tiles", tiles, xs)
    ys = torch.empty((nd, t), dtype=torch.float32, device=dev)
    if nd == 0 or t == 0:
        return ys
    fn = _build.function("spmv_tiles", "spmv_tiles_launch", _ARGTYPES)
    err = fn(dev.index, tiles.data_ptr(), xs.data_ptr(), ys.data_ptr(), nd, t,
             _DTYPES[tiles.dtype], _build.stream_handle(dev))
    _build.raise_on_error("spmv_tiles", err)
    spmv_tiles_cuda.launches += 1
    return ys


spmv_tiles_cuda.launches = 0
