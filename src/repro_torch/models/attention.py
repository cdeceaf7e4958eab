"""Attention: GQA self-attention (full / sliding-window / causal),
single-token decode against a KV cache, and cross-attention.

Port of ``repro/models/attention.py``.  The weights of one attention
block are an :class:`Attention` module (the reference's ``init_attn``)
with the reference's parameter names (``wq``, ``wk``, ``wv``, ``wo`` in
``(d_in, d_out)`` orientation, ``bq``, ``bk``, ``bv`` with a QKV bias); they are
trainable.  ``self_attention`` runs the hand-written ``flash_attention``
kernel under the reference's guard (``use_kernel`` in place of
``use_pallas``), under autograd through its hand-written backward when a
gradient is wanted; every other branch is plain torch, as the
reference's is plain XLA.  Cross-attention (the vlm family's gated
image layers, the audio decoder's attention to the encoder) is
plain torch, as the reference's is: a :class:`CrossAttention` module
(the reference's ``init_cross_attn``: no bias, a 0-d ``gate``, zero at
init) and ``cross_attention``, non-causal over the features.

Under tensor parallelism (weights that are DTensors over the mesh's
``model`` dim, ``models.steps.shard_model``) ``self_attention`` projects
through DTensor products, then runs the attention core (the kernel or
the plain versions) on each rank's local heads, the head counts read
from the local shard: :func:`_local_heads` keeps the query heads a rank
holds whole (all of them where the heads do not divide over the ranks)
and the K/V heads they read, gathered where the K/V shard is not whole
heads.  The output projection's partial sums are all-reduced.

Decode on a mesh (``decode_attention`` with a sharded layer or a cache
split over ranks, as ``sharding.cache_spec`` places it): where the cache
holds a rank's own K/V heads, the rank projects and attends over the
query heads that read them and the output projection's partial sums are
all-reduced, as in prefill; where the cache's positions are split over
ranks, each rank projects every head, only the rank that holds slot
``pos`` writes it, and each computes its slice's scores, running max, sum
and weighted values in float32, combined by a log-sum-exp reduction over
the ranks that split the positions.  The whole cache is never gathered.
"""
from __future__ import annotations

import torch
from torch import nn

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels.flash_attention import flash_attention
from .common import apply_rope, dense_init, rope, tp_in, tp_out

__all__ = ["Attention", "CrossAttention", "project_qkv", "self_attention", "decode_attention",
           "cross_attention"]


class Attention(nn.Module):
    """One attention block's weights (the reference's ``init_attn``),
    drawn from ``generator`` on ``device``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, d_head: int, *,
                 bias: bool, dtype: torch.dtype, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.wq = nn.Parameter(dense_init((d_model, n_heads * d_head), dtype, **kw))
        self.wk = nn.Parameter(dense_init((d_model, n_kv_heads * d_head), dtype, **kw))
        self.wv = nn.Parameter(dense_init((d_model, n_kv_heads * d_head), dtype, **kw))
        self.wo = nn.Parameter(dense_init((n_heads * d_head, d_model), dtype, **kw))
        if bias:
            for name, width in (("bq", n_heads), ("bk", n_kv_heads), ("bv", n_kv_heads)):
                setattr(self, name, nn.Parameter(
                    torch.zeros(width * d_head, dtype=dtype, device=device)))


def _project_qkv(p, x, n_heads, n_kv_heads, d_head):
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(b, s, n_heads, d_head), k.reshape(b, s, n_kv_heads, d_head),
            v.reshape(b, s, n_kv_heads, d_head))


def project_qkv(p, x, *, n_heads, n_kv_heads, d_head, rope_theta):
    """q (B,S,H,D), k and v (B,S,H_kv,D) of a prefill, rotary applied:
    what ``self_attention`` hands its attention core."""
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, d_head)
    if rope_theta:
        cos, sin = rope(torch.arange(x.shape[1], device=x.device), d_head, rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


def _chunked_sdpa(q, k, v, *, causal, window, block_k: int = 512):
    """Online-softmax attention over kv chunks of ``block_k`` keys; the
    same masking rules as :func:`_sdpa`."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bk = min(block_k, t)
    if t % bk:
        raise ValueError(f"_chunked_sdpa: {t} keys are not a multiple of {bk}")
    qg = q.reshape(b, s, hkv, g, d).float() * (d ** -0.5)
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s if causal else 0)
    m = torch.full((b, hkv, g, s), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, s, d), dtype=torch.float32, device=q.device)
    for j in range(t // bk):
        kb, vb = k[:, j * bk:(j + 1) * bk].float(), v[:, j * bk:(j + 1) * bk].float()
        logits = torch.einsum("bshgd,bthd->bhgst", qg, kb)
        kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
        mask = torch.ones((s, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.where(logits > -1e29, torch.exp(logits - m_new[..., None]), 0.0)
        alpha = torch.exp(torch.clamp_max(m - m_new, 0.0))
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bthd->bhgsd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _sdpa(q, k, v, *, causal, window, q_pos0=0, probs_dtype=None):
    """q (B,S,H,D); k, v (B,T,H_kv,D), grouped to H.  Returns (B,S,H,D)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    # the reference's preferred_element_type=float32: exact products of
    # the input dtype, summed in float32
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float()) * d ** -0.5
    qpos = q_pos0 + torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, -1e30)
    if probs_dtype is not None:
        logits = logits.to(probs_dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(probs_dtype or v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype), v)
    return out.reshape(b, s, h, d)


def _sharded_heads(t: DTensor, n: int) -> bool:
    """Whether ``t`` (B,S,n·D) is split over its mesh in whole heads."""
    return t.placements[0] == Shard(t.ndim - 1) and n % t.device_mesh.size() == 0


def _local_heads(q: DTensor, k: DTensor, v: DTensor, n_heads, n_kv_heads, d_head):
    """The attention core's inputs on this rank, from the projections'
    DTensors (B,S,H·D), (B,S,H_kv·D): q (B,S,m,D) for the rank's m query
    heads, k and v (B,S,n,D) for the K/V heads they read (head i of q
    reads K/V head i // (m/n)), and the placement of the core's output.
    Queries split over the ranks in whole heads stay split; otherwise
    every rank takes all heads.  K/V that are not split to match are
    gathered, and each rank keeps the heads its queries read; their
    gradient is then a partial sum over the ranks."""
    b, s = q.shape[:2]
    mesh = q.device_mesh
    tp, rank = mesh.size(), mesh.get_local_rank()
    rep = [Replicate()]
    if _sharded_heads(q, n_heads):
        ql, m, a, out = q.to_local(), n_heads // tp, rank * n_heads // tp, Shard(2)
    else:
        ql, m, a, out = q.redistribute(mesh, rep).to_local(), n_heads, 0, Replicate()
    ql = ql.reshape(b, s, m, d_head)
    g = n_heads // n_kv_heads
    if out == Shard(2) and _sharded_heads(k, n_kv_heads) and a % g == 0 and m % g == 0:
        return ql, k.to_local().reshape(b, s, m // g, d_head), \
            v.to_local().reshape(b, s, m // g, d_head), out
    grad = [Partial()] if out == Shard(2) else rep
    kf, vf = (t.redistribute(mesh, rep).to_local(grad_placements=grad)
              .reshape(b, s, n_kv_heads, d_head) for t in (k, v))
    if a % g == 0 and m % g == 0:                 # whole groups: a slice of K/V heads
        sl = slice(a // g, (a + m) // g)
    elif a // g == (a + m - 1) // g:              # all m heads read one K/V head
        sl = slice(a // g, a // g + 1)
    else:                                         # one K/V head for each query head
        idx = torch.tensor([(a + i) // g for i in range(m)], device=kf.device)
        return ql, kf.index_select(2, idx), vf.index_select(2, idx), out
    return ql, kf[:, :, sl], vf[:, :, sl], out


def _tp_self_attention(p, x, *, n_heads, n_kv_heads, d_head, rope_theta, causal, window,
                       use_kernel, impl, probs_dtype):
    """``self_attention`` with DTensor weights: the core on local heads."""
    b, s, _ = x.shape
    xd = tp_in(x, p.wq)
    q, k, v = xd @ p.wq, xd @ p.wk, xd @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q, k, v, placement = _local_heads(q, k, v, n_heads, n_kv_heads, d_head)
    if rope_theta:
        cos, sin = rope(torch.arange(s, device=x.device), d_head, rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = _attention_core(q, k, v, causal=causal, window=window, use_kernel=use_kernel,
                          impl=impl, probs_dtype=probs_dtype)
    out = DTensor.from_local(out.reshape(b, s, -1), p.wo.device_mesh,
                             [Shard(2) if placement == Shard(2) else Replicate()],
                             run_check=False)
    return tp_out(out @ p.wo)


def _attention_core(q, k, v, *, causal, window, use_kernel, impl, probs_dtype):
    """q (B,S,H,D), k and v (B,S,H_kv,D) → (B,S,H,D): the kernel under the
    reference's guard, else the chunked or the full plain attention."""
    s, d_head = q.shape[1], q.shape[3]
    if use_kernel and not window and d_head % 64 == 0 and s % 128 == 0:
        # the kernel reads the shared K/V head in place of the reference's repeat
        return flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(), causal=causal).transpose(1, 2)
    if impl == "chunked" and s > 512:
        return _chunked_sdpa(q, k, v, causal=causal, window=window)
    return _sdpa(q, k, v, causal=causal, window=window, probs_dtype=probs_dtype)


def self_attention(p, x, *, n_heads, n_kv_heads, d_head, rope_theta, causal=True, window=0,
                   use_kernel=False, impl="full", probs_dtype=None):
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, d_head=d_head, rope_theta=rope_theta)
    if isinstance(p.wq, DTensor):
        return _tp_self_attention(p, x, causal=causal, window=window, use_kernel=use_kernel,
                                  impl=impl, probs_dtype=probs_dtype, **kw)
    b, s, _ = x.shape
    q, k, v = project_qkv(p, x, **kw)
    out = _attention_core(q, k, v, causal=causal, window=window, use_kernel=use_kernel,
                          impl=impl, probs_dtype=probs_dtype)
    return out.reshape(b, s, n_heads * d_head) @ p.wo


def _tp_decode_qkv(p, x, n_heads, n_kv_heads, d_head, hkv: int):
    """q, k, v (B,1,·,D) of one decode token through DTensor weights: the
    rank's own heads where its cache holds ``hkv`` < ``n_kv_heads`` K/V
    heads (the projections' shards are then whole heads, the query heads
    reading those K/V heads), else every head, gathered; and whether the
    heads are the rank's own."""
    b = x.shape[0]
    xd = tp_in(x, p.wq)
    q, k, v = xd @ p.wq, xd @ p.wk, xd @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if hkv == n_kv_heads:
        rep = [Replicate()]
        return (*(t.redistribute(t.device_mesh, rep).to_local().reshape(b, 1, -1, d_head)
                  for t in (q, k, v)), False)
    if not (_sharded_heads(q, n_heads) and _sharded_heads(k, n_kv_heads)
            and k.to_local().shape[-1] == hkv * d_head):
        raise NotImplementedError(
            "decode with a cache split over K/V heads needs the projections split over the "
            "same whole heads (ROADMAP A2)")
    return (*(t.to_local().reshape(b, 1, -1, d_head) for t in (q, k, v)), True)


def _split_attention(qg, cache_k, cache_v, pos, seq_split):
    """Decode attention over this rank's slice of a cache whose positions
    are split over ranks: ``seq_split`` = (the global position of the
    slice's first slot, the groups of the ranks that split the positions).
    Scores, the running max, the sum and the weighted values in float32,
    combined over the groups by log-sum-exp → (B,1,H_kv,G,D) float32."""
    offset, groups = seq_split
    t = cache_k.shape[1]
    logits = torch.einsum("bshgd,bthd->bhgst", qg, cache_k).float() * qg.shape[-1] ** -0.5
    valid = offset + torch.arange(t, device=qg.device) <= pos
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(-1, keepdim=True)
    for group in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    probs = torch.where(valid, torch.exp(logits - m), 0.0)
    acc = torch.einsum("bhgst,bthd->bshgd", probs, cache_v.float())
    acc = torch.cat([acc, probs.sum(-1).permute(0, 3, 1, 2)[..., None]], -1)
    for group in groups:
        dist.all_reduce(acc, group=group)
    return acc[..., :-1] / acc[..., -1:]


def decode_attention(p, x, cache_k, cache_v, pos, *, n_heads, n_kv_heads, d_head,
                     rope_theta, window=0, seq_split=None):
    """One-token decode.  x (B,1,d); cache (B,T,H_kv,D); pos a 0-d int tensor.

    Returns (out (B,1,d), cache_k, cache_v).  Unlike the reference, the
    caches are updated in place (one slot per call) and returned as the
    same tensors.  For sliding-window layers the cache is a ring buffer
    of size ``window``.

    On a mesh (see the module's docstring) the weights are DTensors over
    the ``model`` ranks, the cache is this rank's shard (its own K/V heads
    where it holds fewer than ``n_kv_heads``), and ``seq_split`` = (offset,
    groups) where the shard holds positions ``offset`` … ``offset + T − 1``
    of a cache split over the ranks of ``groups``.
    """
    b = x.shape[0]
    hkv = cache_k.shape[2]
    own = False
    if isinstance(p.wq, DTensor):
        q, k, v, own = _tp_decode_qkv(p, x, n_heads, n_kv_heads, d_head, hkv)
    else:
        q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, d_head)
    if rope_theta:
        cos, sin = rope(pos[None], d_head, rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    t = cache_k.shape[1]
    qg = q.reshape(b, 1, hkv, q.shape[2] // hkv, d_head)
    if seq_split is not None:
        if window:
            raise NotImplementedError(
                "decode of a sliding-window ring cache split over ranks is not ported "
                "(ROADMAP A2)")
        local = pos - seq_split[0]
        mine = (local >= 0) & (local < t)             # only the slot's holder writes it
        slot = local.clamp(0, t - 1).reshape(1).long()
        cache_k.index_copy_(1, slot, torch.where(mine, k, cache_k.index_select(1, slot)))
        cache_v.index_copy_(1, slot, torch.where(mine, v, cache_v.index_select(1, slot)))
        out = _split_attention(qg, cache_k, cache_v, pos, seq_split).to(cache_v.dtype)
    else:
        slot = (pos % max(t, 1) if window else pos).reshape(1).long()
        cache_k.index_copy_(1, slot, k)
        cache_v.index_copy_(1, slot, v)
        logits = torch.einsum("bshgd,bthd->bhgst", qg, cache_k).float() * d_head ** -0.5
        kpos = torch.arange(t, device=x.device)
        if window:
            valid = (kpos <= slot) | (pos >= t)       # ring buffer: the last `window` positions
        else:
            valid = kpos <= pos
        logits = torch.where(valid, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
        out = torch.einsum("bhgst,bthd->bshgd", probs, cache_v)
    out = out.reshape(b, 1, -1)
    if isinstance(p.wo, DTensor):
        out = DTensor.from_local(out, p.wo.device_mesh, [Shard(2) if own else Replicate()],
                                 run_check=False)
        return tp_out(out @ p.wo), cache_k, cache_v
    return out @ p.wo, cache_k, cache_v


class CrossAttention(Attention):
    """One cross-attention block's weights (the reference's
    ``init_cross_attn``): ``wq``, ``wk``, ``wv``, ``wo`` without bias and a
    0-d ``gate`` in the param dtype, zero at init (Llama-3.2-Vision's tanh
    gate)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, d_head: int, *,
                 dtype: torch.dtype, generator: torch.Generator | None = None, device=None):
        super().__init__(d_model, n_heads, n_kv_heads, d_head, bias=False, dtype=dtype,
                         generator=generator, device=device)
        self.gate = nn.Parameter(torch.zeros((), dtype=dtype, device=device))


def cross_attention(p, x, kv_feats, *, n_heads, n_kv_heads, d_head, gated=True):
    """x (B,S,d) queries; kv_feats (B,T,d) encoder or vision features.
    Every query sees every feature (no mask, no rotary); gated, the output
    is scaled by tanh of the gate (in float32, cast to the output dtype)."""
    b, s, _ = x.shape
    t = kv_feats.shape[1]
    q = (x @ p.wq).reshape(b, s, n_heads, d_head)
    k = (kv_feats @ p.wk).reshape(b, t, n_kv_heads, d_head)
    v = (kv_feats @ p.wv).reshape(b, t, n_kv_heads, d_head)
    out = _sdpa(q, k, v, causal=False, window=0).reshape(b, s, n_heads * d_head) @ p.wo
    if gated:
        out = torch.tanh(p.gate.float()).to(out.dtype) * out
    return out
