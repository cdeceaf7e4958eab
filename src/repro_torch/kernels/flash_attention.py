"""Fused attention for the LM's forward and its gradient: online softmax
in float32, grouped K/V heads, suffix-aligned causal masking.

Port of the Pallas kernel ``repro/kernels/attn_tile.py::flash_attention``.
The forward's CUDA kernel is ``csrc/flash_attention.cu`` (its header says
what bounds it and how it is laid out): bfloat16 runs on the tensor cores
(``wgmma`` fed by TMA, P split into two bf16 terms), float32 on the CUDA
cores.  The Pallas kernel has no gradient of its own; the backward,
``csrc/flash_attention_bwd.cu``, is new to the port.  It is three kernels:
Δ = rowsum(dO ∘ O), dK/dV per tile of keys and dQ per tile of query rows.
Like the forward it has two routes by dtype:

* bfloat16 (training) on the tensor cores: ``wgmma`` fed by TMA, a
  producer warpgroup streaming tiles through a two-stage ring to two
  consumer warpgroups.  Its products are bf16 with float32 sums; P and dS
  are rounded to bf16 before theirs.  Emulated on the CPU
  (``tests/test_torch_attention_numerics.py``), that lands within 2.3e-3
  to 2.5e-3 of the reference's float32 gradients in relative L2, against
  1.6e-3 to 2.0e-3 with P and dS in float32; the check on the card
  allows 1e-2.
  q, k, v and dout must start on 16 bytes (TMA), else the wrapper raises.
* float32 (exactness checks) on the CUDA cores.

The work is bound by operations: the five products of a backward do
10·D flops a visible (query, key) pair.  Both routes do seven, because the
dQ kernel recomputes S and dP: a block owns its rows of each gradient and
sums them in one order, so there are no atomics and two runs give the
same bits.  :class:`FlashAttentionFn` joins forward and backward under
autograd: its forward saves ``q, k, v, out`` and the rows' log-sum-exp.

The plain versions are :func:`repro_torch.kernels.ref.attention_ref`
(the inference forward), :func:`~repro_torch.kernels.ref.attention_fwd_ref`
and :func:`~repro_torch.kernels.ref.attention_bwd_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_bwd",
           "flash_attention_bwd_cuda", "FlashAttentionFn", "HEAD_DIMS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the CUDA kernels are compiled for
HEAD_DIMS = (64, 128)
_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P)
_BWD_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 ctypes.c_float, _I, _P)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,H,S_q,D), k and v (B,H_kv,S_k,D) with H a multiple of H_kv →
    (B,H,S_q,D) in q's dtype.  Head h reads K/V head ``h // (H // H_kv)``;
    with ``causal`` query row i sees keys j ≤ i + (S_k − S_q).

    With grad mode on and an input that requires grad, the call goes
    through :class:`FlashAttentionFn`, whose backward is a kernel too.
    Tensors on the CPU take the plain versions; anything else launches
    the CUDA kernels, which raise for a tensor that is not on a card.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    if _on_cpu(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)


def _check_qkv(name, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be (B,H,S_q,D) and k, v (B,H_kv,S_k,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    h_kv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or h_kv == 0 or h % h_kv:
        raise ValueError(f"{name}: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head width {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, return_lse: bool = False):
    """The CUDA forward kernel alone; counts its launches in ``.launches``.
    With ``return_lse`` it also writes each row's float32 log-sum-exp
    (B,H,S_q) (``+inf`` for a row with no visible key) and returns
    ``(out, lse)``."""
    dev = _build.require_cuda("flash_attention", q, k, v)
    _check_qkv("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    _build.require_contiguous("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: bf16 q, k, v and the output must start on a "
                         "16-byte boundary (the tensor-core route reads them with TMA)")
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGTYPES)
    err = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if return_lse else None, b, h, h_kv, sq, sk, d, int(causal),
             d ** -0.5, _DTYPES[q.dtype], _build.stream_handle(dev))
    _build.raise_on_error("flash_attention", err)
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True):
    """``(dq, dk, dv)`` of ``flash_attention`` for the output gradient
    ``dout``, from the forward's ``out`` and ``lse``.  CPU tensors take
    :func:`~repro_torch.kernels.ref.attention_bwd_ref`; anything else
    launches the CUDA kernels."""
    if _on_cpu(q, k, v, out, lse, dout):
        return ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    return flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True):
    """The CUDA backward alone (its three kernels are one launch of the
    wrapper); counts its launches in ``.launches``.  Returns ``(dq, dk,
    dv)`` in the inputs' dtype."""
    name = "flash_attention_bwd"
    dev = _build.require_cuda(name, q, k, v, out, lse, dout)
    _check_qkv(name, q, k, v)
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError(f"{name}: out and dout must be {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(out.shape)} {out.dtype}, {tuple(dout.shape)} {dout.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be ({b}, {h}, {sq}) float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    _build.require_contiguous(name, q, k, v, out, lse, dout)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError(f"{name}: bf16 q, k, v and dout must start on a 16-byte boundary "
                         "(the tensor-core route reads them with TMA)")
    # the kernels write every element: zeros where S_q or S_k is 0
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    fn = _build.function(name, "flash_attention_bwd_launch", _BWD_ARGTYPES)
    err = fn(dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), b, h, h_kv, sq, sk, d, int(causal), d ** -0.5, _DTYPES[q.dtype],
             _build.stream_handle(dev))
    _build.raise_on_error(name, err)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd.  The forward saves ``q, k, v,
    out, lse``; the backward returns ``(dq, dk, dv)``.  Both dispatch by
    device: CPU tensors take the plain versions, CUDA tensors launch the
    kernels or raise."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if _on_cpu(q, k, v):
            out, lse = ref.attention_fwd_ref(q, k, v, causal=causal)
        else:
            out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None
