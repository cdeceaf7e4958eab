"""ELL-format SpMV: ``y[b, r] = Σ_k x[b, idx[b, r, k]] · valid[b, r, k]``.

Port of the Pallas kernel ``repro/kernels/spmv_ell.py::spmv_ell``.  No
algorithm of either package calls it yet.  The CUDA kernel is
``csrc/spmv_ell.cu`` (a group of lanes per row: int4 index loads
where K is a multiple of 4, scalar ones otherwise); the plain version is
:func:`repro_torch.kernels.ref.spmv_ell_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["spmv_ell", "spmv_ell_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def spmv_ell(idx: torch.Tensor, valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,R,K) int32 idx + (B,R,K) mask + (B,N) x → (B,R) in x's dtype.

    Tensors on the CPU take the plain version; anything else launches
    the CUDA kernel, which raises for a tensor that is not on a card.
    """
    if all(t.device.type == "cpu" for t in (idx, valid, x)):
        return ref.spmv_ell_ref(idx, valid, x)
    return spmv_ell_cuda(idx, valid, x)


def spmv_ell_cuda(idx: torch.Tensor, valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel alone; counts its launches in ``.launches``.  The
    mask must be bool; entries it masks are not read, so their indices
    may lie outside [0, N)."""
    dev = _build.require_cuda("spmv_ell", idx, valid, x)
    if idx.dim() != 3 or valid.shape != idx.shape or x.dim() != 2 or x.shape[0] != idx.shape[0]:
        raise ValueError(f"spmv_ell: idx and valid must be (B,R,K) and x (B,N); got "
                         f"{tuple(idx.shape)}, {tuple(valid.shape)}, {tuple(x.shape)}")
    if idx.dtype != torch.int32 or valid.dtype != torch.bool or x.dtype not in _DTYPES:
        raise TypeError(f"spmv_ell: takes int32 idx, bool valid and float32 or bfloat16 x; "
                        f"got {idx.dtype}, {valid.dtype}, {x.dtype}")
    _build.require_contiguous("spmv_ell", idx, valid, x)
    b, r, k = idx.shape
    y = torch.empty((b, r), dtype=x.dtype, device=dev)
    if y.numel() == 0:
        return y
    # int4 index and 4-byte mask loads where each row's entries start aligned
    vec = k % 4 == 0 and idx.data_ptr() % 16 == 0 and valid.data_ptr() % 4 == 0
    fn = _build.function("spmv_ell", "spmv_ell_launch", _ARGTYPES)
    err = fn(dev.index, idx.data_ptr(), valid.data_ptr(), x.data_ptr(), y.data_ptr(), b, r, k,
             x.shape[1], _DTYPES[x.dtype], int(vec), _build.stream_handle(dev))
    _build.raise_on_error("spmv_ell", err)
    spmv_ell_cuda.launches += 1
    return y


spmv_ell_cuda.launches = 0
