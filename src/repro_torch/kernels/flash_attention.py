"""Fused attention for the LM's prefill and eval forward: online softmax
in float32, grouped K/V heads, suffix-aligned causal masking.

Port of the Pallas kernel ``repro/kernels/attn_tile.py::flash_attention``.
The CUDA kernel is ``csrc/flash_attention.cu`` (its header says what
bounds it and how it is laid out): bfloat16 runs on the tensor cores
(``wgmma`` fed by TMA, P split into two bf16 terms), float32 on the CUDA
cores.  The plain version is :func:`repro_torch.kernels.ref.attention_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["flash_attention", "flash_attention_cuda", "HEAD_DIMS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the CUDA kernel is compiled for
HEAD_DIMS = (64, 128)
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,H,S_q,D), k and v (B,H_kv,S_k,D) with H a multiple of H_kv →
    (B,H,S_q,D) in q's dtype.  Head h reads K/V head ``h // (H // H_kv)``;
    with ``causal`` query row i sees keys j ≤ i + (S_k − S_q).

    Tensors on the CPU take the plain version; anything else launches
    the CUDA kernel, which raises for a tensor that is not on a card.
    """
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """The CUDA kernel alone; counts its launches in ``.launches``."""
    dev = _build.require_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B,H,S_q,D) and k, v (B,H_kv,S_k,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h_kv == 0 or h % h_kv:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    _build.require_contiguous("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: bf16 q, k, v and the output must start on a "
                         "16-byte boundary (the tensor-core route reads them with TMA)")
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGTYPES)
    err = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, h_kv,
             sq, sk, d, int(causal), d ** -0.5, _DTYPES[q.dtype], _build.stream_handle(dev))
    _build.raise_on_error("flash_attention", err)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
