"""Dense-tile triangle count, triangle counting's dense (K_D) path.

``Σ_b Σ_{r,s} (A_ik[b] · A_jk[b]ᵀ)[r,s] · A_ij[b][r,s]`` where triple
``b`` is ``idx[b] = (ij, ik, jk)``, three tile numbers of one tile batch;
a triple whose ``ij`` is negative counts nothing.  Port of the Pallas
kernel ``repro/kernels/tc_tile.py::tc_tiles``, which took the three
gathered ``(B, T, T)`` operands: this one reads the tiles in place, so
those copies are never built.  The CUDA kernel is ``csrc/tc_tiles.cu``;
the plain version is :func:`repro_torch.kernels.ref.tc_tiles_idx_ref`.
The count is an exact int64 on both.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["tc_tiles", "tc_tiles_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def tc_tiles(tiles: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(nd, T, T) tiles × (B, 3) int32 triples → 0-d int64 count.

    Tensors on the CPU take the plain version; anything else launches
    the CUDA kernel, which raises for a tensor that is not on a card.
    """
    if tiles.device.type == "cpu" and idx.device.type == "cpu":
        return ref.tc_tiles_idx_ref(tiles, idx)
    return tc_tiles_cuda(tiles, idx)


def tc_tiles_cuda(tiles: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel alone; counts its launches in ``.launches``."""
    dev = _build.require_cuda("tc_tiles", tiles, idx)
    if tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2]:
        raise ValueError(f"tc_tiles: tiles must be (nd, T, T); got {tuple(tiles.shape)}")
    if idx.dim() != 2 or idx.shape[1] != 3 or idx.dtype != torch.int32:
        raise ValueError(
            f"tc_tiles: idx must be (B, 3) int32; got {tuple(idx.shape)} {idx.dtype}")
    if tiles.dtype not in _DTYPES:
        raise TypeError(f"tc_tiles: tiles must be float32 or bfloat16; got {tiles.dtype}")
    _build.require_contiguous("tc_tiles", tiles, idx)
    nd, t, nb = tiles.shape[0], tiles.shape[1], idx.shape[0]
    # the kernel reads tiles[idx[b, :]] for every triple with idx[b, 0] >= 0
    live = idx[idx[:, 0] >= 0]
    if live.numel() and bool(((live < 0) | (live >= nd)).any()):
        raise IndexError(f"tc_tiles: a live triple names a tile outside [0, {nd})")
    if nb == 0 or t == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)  # zeroed by the launch
    fn = _build.function("tc_tiles", "tc_tiles_launch", _ARGTYPES)
    err = fn(dev.index, tiles.data_ptr(), idx.data_ptr(), count.data_ptr(), nb, t,
             _DTYPES[tiles.dtype], _build.stream_handle(dev))
    _build.raise_on_error("tc_tiles", err)
    tc_tiles_cuda.launches += 1
    return count


tc_tiles_cuda.launches = 0
