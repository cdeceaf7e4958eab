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
    "tc_tiles_idx_ref", "spmv_ell_ref", "attention_ref", "attention_fwd_ref",
    "attention_bwd_ref",
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


def _visible(s_q: int, s_k: int, causal: bool, device) -> torch.Tensor:
    """(S_q, S_k) bool: key j is visible to row i (suffix-aligned causal)."""
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    return mask.tril(diagonal=s_k - s_q) if causal else mask


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 for float32 and bf16 inputs; float64 stays float64 (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _grouped(q, k):
    """q (B,H,S,D) as (B,H_kv,G,S,D) in the working dtype, and the scale."""
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    return q.to(_work_dtype(q)).reshape(b, h_kv, h // h_kv, s, d), d ** -0.5


def attention_fwd_ref(q, k, v, *, causal: bool = True):
    """The forward of :func:`attention_ref` with the row statistics the
    backward needs: ``(out, lse)``, out (B,H,S_q,D) in q's dtype and lse
    (B,H,S_q) the natural-log log-sum-exp of each row's scaled scores,
    in float32 (float64 for float64 inputs).

    A row with no visible key gives out 0, as the kernel does, and lse
    ``+inf``, so that its probabilities exp(s − lse), and every gradient
    it sends, are exactly 0.  Batch elements are taken one at a time so
    that the (H, S_q, S_k) score temporaries stay bounded."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    wt = _work_dtype(q)
    mask = _visible(s_q, s_k, causal, q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=wt, device=q.device)
    for i in range(b):
        qg, scale = _grouped(q[i:i + 1], k)
        logits = torch.einsum("bngqd,bnkd->bngqk", qg, k[i:i + 1].to(wt)) * scale
        logits = logits.masked_fill(~mask, float("-inf"))
        row = torch.logsumexp(logits, -1)
        row = torch.where(torch.isneginf(row), float("inf"), row)
        probs = torch.exp(logits - row[..., None])
        o = torch.einsum("bngqk,bnkd->bngqd", probs, v[i:i + 1].to(wt))
        out[i] = o.reshape(h, s_q, d).to(q.dtype)
        lse[i] = row.reshape(h, s_q)
    return out, lse


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True):
    """Gradients ``(dq, dk, dv)`` of :func:`attention_fwd_ref` for the
    output gradient ``dout``, from the saved ``out`` and ``lse``, written
    as the explicit formulas (scale = D^-½):

        P = exp(scale·QKᵀ − lse), masked;   dV = Pᵀ dO;   dP = dO Vᵀ;
        Δ = rowsum(dO ∘ O);   dS = P ∘ (dP − Δ);
        dQ = scale·dS K;   dK = scale·dSᵀ Q,

    dK and dV summed over the H/H_kv query heads that share a K/V head.
    Float32 work (float64 for float64 inputs), cast to the input dtype;
    one batch element at a time."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    wt = _work_dtype(q)
    mask = _visible(s_q, s_k, causal, q.device)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    for i in range(b):
        qg, scale = _grouped(q[i:i + 1], k)
        kf, vf = k[i:i + 1].to(wt), v[i:i + 1].to(wt)
        og, _ = _grouped(out[i:i + 1].to(wt), k)
        dog, _ = _grouped(dout[i:i + 1].to(wt), k)
        row = lse[i:i + 1].to(wt).reshape(1, h_kv, h // h_kv, s_q, 1)
        logits = torch.einsum("bngqd,bnkd->bngqk", qg, kf) * scale
        p = torch.where(mask, torch.exp(logits - row), 0.0)
        dv[i] = torch.einsum("bngqk,bngqd->bnkd", p, dog)[0].to(v.dtype)
        dp = torch.einsum("bngqd,bnkd->bngqk", dog, vf)
        delta = (dog * og).sum(-1, keepdim=True)
        ds = p * (dp - delta)
        dq[i] = (scale * torch.einsum("bngqk,bnkd->bngqd", ds, kf)).reshape(h, s_q, d).to(q.dtype)
        dk[i] = (scale * torch.einsum("bngqk,bngqd->bnkd", ds, qg))[0].to(k.dtype)
    return dq, dk, dv
