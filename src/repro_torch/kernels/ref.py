"""Plain PyTorch versions of every kernel (the ``ref.py`` contract).

Each function is the mathematical definition of the corresponding
kernel of the reference package (``repro/kernels/ref.py``), written with
plain tensor operations.  The kernel wrappers take these for tensors
that lie on the CPU; the tests and ``chip_smoke.py`` hold the CUDA
kernels against them on the card.  Nothing on the main path calls them
for CUDA tensors.

The tile versions work over the tile batch in chunks so that their
``(chunk, T, T)`` temporaries stay bounded at the main path's shapes.
Those that take ``extents`` (the block rectangle inside each padded
tile, outside which a tile is zero) ignore it and read whole tiles, so
that holding a kernel against them tests the kernel's cropping.

Host-compute contract
---------------------
The plain versions double as the *host CPU* implementations of
heterogeneous co-scheduling (:mod:`repro_torch.core.stream`'s host
lane): the lane's units hold CPU tensors, so every wrapper dispatches
them here, and they give the same integer/boolean results as the CUDA
kernels.  A kernel name in :data:`HOST_EXECUTABLE` certifies exactly
that; :func:`repro_torch.kernels.registry.host_executable` exposes it,
and the streaming executor refuses to peel tasks of an algorithm that
names a kernel outside the set in ``metadata["host_kernels"]``.
"""
from __future__ import annotations

import torch

INT_MAX = 2**31 - 1
#: the kernels' masked score (finite, so an empty softmax row stays finite)
NEG = -1e30

#: tiles per chunk of the batched plain versions
CHUNK = 256

#: kernel names whose plain version is certified to run on the host CPU
#: lane (plain torch, deterministic, bit-identical int/bool results)
HOST_EXECUTABLE = ("spmv_tiles", "frontier_tiles", "tc_tiles")

__all__ = [
    "INT_MAX", "NEG", "HOST_EXECUTABLE", "spmv_tiles_ref", "frontier_tiles_ref", "tc_tiles_ref",
    "tc_tiles_idx_ref", "spmv_ell_ref", "attention_ref",
]


def _per_query(fn, tiles: torch.Tensor, vecs: torch.Tensor, dtype) -> torch.Tensor:
    """``fn`` on each query row of ``vecs`` (Q, nd, T) against the shared
    tiles: row q of the result is exactly ``fn(tiles, vecs[q])``."""
    out = torch.empty(vecs.shape, dtype=dtype, device=vecs.device)
    for q in range(vecs.shape[0]):
        out[q] = fn(tiles, vecs[q])
    return out


def spmv_tiles_ref(tiles: torch.Tensor, xs: torch.Tensor, extents=None) -> torch.Tensor:
    """y[b] = A[b]ᵀ · x[b] for a batch of dense blocks — (nd,T,T),(nd,T)→(nd,T) f32;
    with a query axis, (Q,nd,T) slices against the shared tiles give
    (Q,nd,T).  ``extents`` is ignored: whole tiles are read."""
    if xs.dim() == 3:
        return _per_query(spmv_tiles_ref, tiles, xs, torch.float32)
    out = torch.empty(xs.shape, dtype=torch.float32, device=xs.device)
    for s in range(0, tiles.shape[0], CHUNK):
        a = tiles[s:s + CHUNK].float()
        x = xs[s:s + CHUNK].float()
        out[s:s + CHUNK] = (a * x[:, :, None]).sum(dim=1)
    return out


def frontier_tiles_ref(tiles: torch.Tensor, fcols: torch.Tensor,
                       extents=None) -> torch.Tensor:
    """Bottom-up BFS tile step: per tile row, the smallest local column c
    with an edge into the frontier, else INT_MAX — (nd,T,T),(nd,T)→(nd,T) i32;
    with a query axis, (Q,nd,T) frontiers against the shared tiles give
    (Q,nd,T).  ``extents`` is ignored: whole tiles are read."""
    if fcols.dim() == 3:
        return _per_query(frontier_tiles_ref, tiles, fcols, torch.int32)
    t = tiles.shape[-1]
    colid = torch.arange(t, dtype=torch.int32, device=tiles.device)[None, None, :]
    out = torch.empty(fcols.shape, dtype=torch.int32, device=tiles.device)
    for s in range(0, tiles.shape[0], CHUNK):
        hit = (tiles[s:s + CHUNK] > 0) & (fcols[s:s + CHUNK, None, :] > 0)
        out[s:s + CHUNK] = torch.where(hit, colid, INT_MAX).amin(dim=2)
    return out


def tc_tiles_ref(a_ik: torch.Tensor, a_jk: torch.Tensor,
                 a_ij: torch.Tensor) -> torch.Tensor:
    """Σ_b Σ_{r,s} (A_ik[b] · A_jk[b]ᵀ)[r,s] * A_ij[b][r,s]  → scalar f32.

    The reference oracle's own arithmetic: an f32 sum, exact only while
    the count stays below 2**24.
    """
    w = torch.einsum("brc,bsc->brs", a_ik.float(), a_jk.float())
    return torch.sum(w * a_ij.float())


def tc_tiles_idx_ref(tiles: torch.Tensor, idx: torch.Tensor,
                     extents=None) -> torch.Tensor:
    """Triangle count of the tile triples ``idx`` (B,3) = (ij, ik, jk)
    read out of ``tiles`` — rows whose ``ij`` entry is negative count
    nothing.  Gathers the operands chunk by chunk and contracts them as
    :func:`tc_tiles_ref` does; each entry of the masked wedge matrix is
    an integer ≤ T, so the chunk sums are taken in int64 and the count
    is exact.  ``extents`` is ignored: whole tiles are read.  Returns a
    0-d int64 tensor."""
    total = torch.zeros((), dtype=torch.int64, device=tiles.device)
    idx = idx.long()
    for s in range(0, idx.shape[0], CHUNK):
        rows = idx[s:s + CHUNK]
        rows = rows[rows[:, 0] >= 0]
        if not rows.shape[0]:
            continue
        a_ij = tiles[rows[:, 0]].float()
        a_ik = tiles[rows[:, 1]].float()
        a_jk = tiles[rows[:, 2]].float()
        w = torch.einsum("brc,bsc->brs", a_ik, a_jk)
        total += (w * a_ij).to(torch.int64).sum()
    return total


def spmv_ell_ref(idx: torch.Tensor, valid: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """(B,R,K) gather-and-mask row sums: y[b,r] = Σ_k x[b, idx[b,r,k]]·valid."""
    b, r, k = idx.shape
    gathered = torch.gather(x, 1, idx.reshape(b, r * k).long()).reshape(b, r, k)
    return torch.sum(gathered * valid.to(x.dtype), dim=2)


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Softmax attention as the kernel computes it — q (B,H,S_q,D), k and v
    (B,H_kv,S_k,D) with H a multiple of H_kv → (B,H,S_q,D) in q's dtype.

    Head h reads K/V head ``h // (H // H_kv)`` (the reference's repeat on
    the head axis).  Float32 throughout, scale applied to q; causal is
    suffix-aligned (row i sees keys j ≤ i + S_k − S_q).  Masked scores
    are -1e30 and the denominator is kept above 1e-30, as in the kernel,
    so a row with no visible key comes out 0 (the JAX oracle's ``-inf``
    gives NaN there).
    """
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k, v = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        logits = logits.masked_fill(~mask, NEG)
    m = logits.amax(-1, keepdim=True)
    probs = torch.where(logits > NEG / 2, torch.exp(logits - m), 0.0)
    den = probs.sum(-1, keepdim=True).clamp_min(1e-30)
    return (torch.einsum("bhqk,bhkd->bhqd", probs, v.float()) / den).to(q.dtype)
