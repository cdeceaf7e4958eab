"""Recurrent sequence mixers: Mamba (S6) for the hybrid family and mLSTM /
sLSTM for the ssm (xLSTM) family.

Port of ``repro/models/ssm.py``.  Each mixer's weights are an
``nn.Module`` with the reference's parameter names (:class:`Mamba`,
:class:`MLSTM`, :class:`SLSTM`: the reference's ``init_mamba``,
``init_mlstm`` and ``init_slstm``).  The parameters the reference makes
float32 stay float32 under any config dtype: Mamba's ``a_log``,
``dt_bias`` and ``d_skip``, the xLSTM gates' ``wi``, ``wf``, ``bf`` and
``bi``, and sLSTM's ``rz``.

Each mixer has a sequence form (prefill and training) and a step form
(one-token decode with an explicit carried state), and computes what the
reference computes in plain XLA, here in plain torch:

* the recurrent forms (``mamba_seq``, ``mlstm_seq``, ``slstm_seq``) are a
  Python loop over time.  What does not read the carried state is
  computed for a whole chunk of time at once: the projections, Mamba's
  decay and input terms, and the xLSTM's log-space stabiliser, whose
  recurrence reads the gates alone.  Each timestep then issues only the
  ops that read the state (Mamba one, mLSTM four, sLSTM seven, and two
  for the stabiliser).  Sequences longer than 256 steps and a multiple of
  256 run in 256-step chunks, each a ``torch.utils.checkpoint`` when a
  backward will follow: the reference's ``jax.checkpoint`` chunks, which
  change memory, not values;
* ``mamba_seq_assoc`` is the reference's ``lax.associative_scan``: ⌈log₂ S⌉
  doubling passes over ``(B,S,d,N)`` float32 tensors;
* ``mlstm_seq_chunked`` is the chunkwise-parallel mLSTM, a loop over
  chunks of ``chunk`` steps.  It raises ``ValueError`` where the
  reference asserts that the chunk divides the sequence.

The stabiliser ``m`` starts at −1e30 in float32 in every form.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.engine import resolve_device
from .common import dense_init

__all__ = [
    "Mamba", "mamba_seq", "mamba_seq_assoc", "mamba_step", "mamba_init_state",
    "MLSTM", "mlstm_seq", "mlstm_seq_chunked", "mlstm_step", "mlstm_init_state",
    "SLSTM", "slstm_seq", "slstm_step", "slstm_init_state",
]

_CHUNK = 256   # remat chunk for sequence scans
M_INIT = -1e30


def _chunked_scan(scan, state, xs, length, *consts):
    """``scan(state, xs, *consts) -> (state, ys)`` over time-major ``xs``
    (a tuple of ``(T, ...)`` tensors), in 256-step chunks when ``length``
    is a larger multiple of 256, each chunk under ``checkpoint`` when a
    backward will follow (only the chunk-boundary states are kept)."""
    if length <= _CHUNK or length % _CHUNK:
        return scan(state, xs, *consts)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (*xs, *consts))
    ys = []
    for i in range(0, length, _CHUNK):
        args = (state, tuple(a[i:i + _CHUNK] for a in xs), *consts)
        state, y = checkpoint(scan, *args, use_reentrant=False) if remat else scan(*args)
        ys.append(y)
    return state, torch.cat(ys)


def _stabilised_gates(i_pre, f_pre, m0):
    """The xLSTM's log-space stabiliser ``m_t = max(f_t + m_{t-1}, i_t)`` run
    from ``m0`` over (T, ...) gate pre-activations.  Returns the gates
    ``exp(i_t − m_t)`` and ``exp(f_t + m_{t-1} − m_t)`` and every ``m_t``."""
    ms, m = [], m0
    for t in range(i_pre.shape[0]):
        m = torch.maximum(f_pre[t] + m, i_pre[t])
        ms.append(m)
    m_prev = torch.stack([m0, *ms[:-1]])
    ms = torch.stack(ms)
    return torch.exp(i_pre - ms), torch.exp(f_pre + m_prev - ms), ms


def _gated_out(x, h, w_gate, wo):
    """The xLSTM blocks' output: ``(h · σ(x w_gate)) wo``."""
    return (h * torch.sigmoid(x @ w_gate)) @ wo


# ======================================================================
# Mamba (S6): selective state space, diagonal A
# ======================================================================


class Mamba(nn.Module):
    """The reference's ``init_mamba``: d_inner = d_model, dt_rank =
    max(1, d/16); ``a_log = log(1..N)`` tiled over d, ``dt_bias`` 0.5 and
    ``d_skip`` 1, all three float32; ``conv_w`` drawn at scale 0.5."""

    def __init__(self, d_model: int, d_state: int, d_conv: int, dtype, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        d_in, dt_rank = d_model, max(1, d_model // 16)
        a = np.tile(np.arange(1, d_state + 1, dtype=np.float32), (d_in, 1))
        self.in_proj = nn.Parameter(dense_init((d_model, 2 * d_in), dtype, **kw))
        self.conv_w = nn.Parameter(dense_init((d_conv, d_in), dtype, scale=0.5, **kw))
        self.x_proj = nn.Parameter(dense_init((d_in, dt_rank + 2 * d_state), dtype, **kw))
        self.dt_proj = nn.Parameter(dense_init((dt_rank, d_in), dtype, **kw))
        self.dt_bias = nn.Parameter(torch.full((d_in,), 0.5, **f32))
        self.a_log = nn.Parameter(torch.from_numpy(np.log(a)).to(device))   # (d_in, N)
        self.d_skip = nn.Parameter(torch.ones(d_in, **f32))
        self.out_proj = nn.Parameter(dense_init((d_in, d_model), dtype, **kw))


def _mamba_inputs(p: Mamba, x, d_state):
    """Shared projections: x (B,S,d) → (u, z in x's dtype; delta, b, c
    float32), u after the causal depthwise convolution and silu."""
    dt_rank = p.dt_proj.shape[0]
    u, z = (x @ p.in_proj).chunk(2, dim=-1)                 # (B,S,d_in) each
    w = p.conv_w                                            # (K, d_in)
    k, s = w.shape[0], u.shape[1]
    upad = F.pad(u, (0, 0, k - 1, 0))
    conv = upad[:, 0:s] * w[0]
    for i in range(1, k):
        conv = conv + upad[:, i:i + s] * w[i]
    u = F.silu(conv)
    dt, b, c = (u @ p.x_proj).split([dt_rank, d_state, d_state], dim=-1)
    delta = F.softplus((dt @ p.dt_proj).float() + p.dt_bias)   # (B,S,d_in) f32
    return u, z, delta, b.float(), c.float()


def _mamba_out(p: Mamba, y, u, z):
    """y (B,S,d_in) float32 → the block's output: the skip, the gate, the
    output projection, in u's dtype."""
    y = y.to(u.dtype) + u * p.d_skip.to(u.dtype)
    return (y * F.silu(z)) @ p.out_proj


def mamba_init_state(batch: int, d_model: int, d_state: int, *, device=None):
    """Zero Mamba state (B,d,N) float32 on ``device`` (default: the current
    card; raises without one)."""
    return torch.zeros((batch, d_model, d_state), dtype=torch.float32,
                       device=resolve_device(device))


def _mamba_scan(h, xs, a):
    """h_t = exp(δ_t a) ⊙ h_{t-1} + (δ_t u_t) b_t, y_t = h_t c_t over
    time-major (u, δ (T,B,d), b, c (T,B,N)); h (B,d,N) float32."""
    u, delta, b, c = xs
    da = torch.exp(delta[..., None] * a)                    # (T,B,d,N)
    bu = (delta * u.float())[..., None] * b[:, :, None, :]
    hs = []
    for t in range(da.shape[0]):
        h = torch.addcmul(bu[t], da[t], h)
        hs.append(h)
    return h, torch.einsum("tbdn,tbn->tbd", torch.stack(hs), c)


def mamba_seq(p: Mamba, x, *, d_state: int):
    """x (B,S,d) → (B,S,d): the recurrent scan over S."""
    u, z, delta, b, c = _mamba_inputs(p, x, d_state)
    a = -torch.exp(p.a_log)                                 # (d_in, N)
    xs = tuple(t.transpose(0, 1).contiguous() for t in (u, delta, b, c))
    h0 = mamba_init_state(x.shape[0], a.shape[0], d_state, device=x.device)
    _, ys = _chunked_scan(_mamba_scan, h0, xs, x.shape[1], a)
    return _mamba_out(p, ys.transpose(0, 1), u, z)


def _assoc_scan(a, b):
    """All states of h_t = a_t ⊙ h_{t-1} + b_t (h_{-1} = 0) along axis 1,
    by doubling: pass j composes each element with the one 2^j before
    it, ``(a_l, b_l) ∘ (a_r, b_r) = (a_l a_r, a_r b_l + b_r)``."""
    s, shift = a.shape[1], 1
    while shift < s:
        b = torch.cat([b[:, :shift], torch.addcmul(b[:, shift:], a[:, shift:], b[:, :-shift])], 1)
        if 2 * shift < s:
            a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], 1)
        shift *= 2
    return b


def mamba_seq_assoc(p: Mamba, x, *, d_state: int):
    """Mamba through an associative scan over S: the same function as
    :func:`mamba_seq`, in ⌈log₂ S⌉ passes over (B,S,d,N) tensors."""
    u, z, delta, b, c = _mamba_inputs(p, x, d_state)
    a = -torch.exp(p.a_log)
    da = torch.exp(delta[..., None] * a)                    # (B,S,d,N)
    bu = (delta * u.float())[..., None] * b[:, :, None, :]
    y = torch.einsum("bsdn,bsn->bsd", _assoc_scan(da, bu), c)
    return _mamba_out(p, y, u, z)


def mamba_step(p: Mamba, x, h, conv_buf, *, d_state: int):
    """One-token decode.  x (B,1,d); h (B,d_in,N) float32; conv_buf
    (B,K-1,d_in), kept in its own dtype.  Returns (out (B,1,d), h, the
    next conv_buf)."""
    dt_rank = p.dt_proj.shape[0]
    u, z = (x @ p.in_proj).chunk(2, dim=-1)
    k = p.conv_w.shape[0]
    seq = torch.cat([conv_buf, u[:, 0:1].to(conv_buf.dtype)], 1)
    u1 = F.silu(torch.einsum("bkd,kd->bd", seq[:, -k:], p.conv_w))      # (B,d_in)
    dt, b, c = (u1 @ p.x_proj).split([dt_rank, d_state, d_state], dim=-1)
    delta = F.softplus((dt @ p.dt_proj).float() + p.dt_bias)
    da = torch.exp(delta[..., None] * -torch.exp(p.a_log))
    h = da * h + (delta * u1.float())[..., None] * b.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c.float()).to(x.dtype)
    y = (y + u1 * p.d_skip.to(x.dtype)) * F.silu(z[:, 0])
    return (y @ p.out_proj)[:, None, :], h, seq[:, 1:]


# ======================================================================
# mLSTM: matrix memory with exponential gating (xLSTM)
# ======================================================================


class MLSTM(nn.Module):
    """The reference's ``init_mlstm``: ``wq``, ``wk``, ``wv``, ``wo`` and
    ``ogate`` (d,d); the gates ``wi``, ``wf`` (d,H) drawn at scale 0.01 and
    the biases ``bf`` = 3 (open forget gates), ``bi`` = 0, all four
    float32."""

    def __init__(self, d_model: int, n_heads: int, dtype, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        d, nh = d_model, n_heads
        self.wq = nn.Parameter(dense_init((d, d), dtype, **kw))
        self.wk = nn.Parameter(dense_init((d, d), dtype, **kw))
        self.wv = nn.Parameter(dense_init((d, d), dtype, **kw))
        self.wi = nn.Parameter(dense_init((d, nh), torch.float32, scale=0.01, **kw))
        self.wf = nn.Parameter(dense_init((d, nh), torch.float32, scale=0.01, **kw))
        self.bf = nn.Parameter(torch.full((nh,), 3.0, **f32))
        self.bi = nn.Parameter(torch.zeros(nh, **f32))
        self.wo = nn.Parameter(dense_init((d, d), dtype, **kw))
        self.ogate = nn.Parameter(dense_init((d, d), dtype, **kw))


def mlstm_init_state(batch: int, n_heads: int, dh: int, *, device=None) -> dict:
    """Zero mLSTM state, ``m`` at −1e30, float32 on ``device`` (default: the
    current card; raises without one)."""
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return dict(c=torch.zeros((batch, n_heads, dh, dh), **f32),
                n=torch.zeros((batch, n_heads, dh), **f32),
                m=torch.full((batch, n_heads), M_INIT, **f32))


def _mlstm_gates(p, x):
    """Input and forget gate pre-activations (B,S,H), float32."""
    x32 = x.float()
    return x32 @ p.wi + p.bi, x32 @ p.wf + p.bf


def _mlstm_qkv(p: MLSTM, x, n_heads: int):
    b, s, d = x.shape
    dh = d // n_heads
    q = (x @ p.wq).reshape(b, s, n_heads, dh)
    k = (x @ p.wk).reshape(b, s, n_heads, dh)
    v = (x @ p.wv).reshape(b, s, n_heads, dh)
    return q, k * dh ** -0.5, v


def _mlstm_cell(state, q_t, k_t, v_t, i_pre, f_pre):
    """One timestep of the stabilized mLSTM recurrence (float32)."""
    c, n, m = state["c"], state["n"], state["m"]
    m_new = torch.maximum(f_pre + m, i_pre)                 # log-space stabilizer
    i_g = torch.exp(i_pre - m_new)[..., None]               # (B,H,1)
    f_g = torch.exp(f_pre + m - m_new)[..., None]
    n = f_g * n + i_g * k_t
    c = f_g[..., None] * c + i_g[..., None] * (v_t[..., :, None] * k_t[..., None, :])
    denom = torch.maximum(torch.einsum("bhk,bhk->bh", n, q_t).abs(),
                          torch.exp(-m_new))[..., None]
    h = torch.einsum("bhvk,bhk->bhv", c, q_t) / denom
    return dict(c=c, n=n, m=m_new), h


def _mlstm_scan(state, xs):
    """The mLSTM recurrence over time-major q, k, v (T,B,H,dh) and gate
    pre-activations (T,B,H), float32; the state is (c (B·H,dv,dk), n
    (B,H,dk), m (B,H)).  Per step: n, the decayed c, the rank-1 update,
    the read-out; the denominators after the loop."""
    c, n, m = state
    q, k, v, i_pre, f_pre = xs
    t_len, b, nh, dh = q.shape
    i_g, f_g, ms = _stabilised_gates(i_pre, f_pre, m)
    i_g, f_g = i_g[..., None], f_g[..., None]               # (T,B,H,1)
    ik, iv = i_g * k, (i_g * v)[..., None]
    ns, hs = [], []
    for t in range(t_len):
        n = torch.addcmul(ik[t], f_g[t], n)
        c = torch.baddbmm(f_g[t].reshape(-1, 1, 1) * c, iv[t].reshape(-1, dh, 1),
                          k[t].reshape(-1, 1, dh))
        hs.append(torch.bmm(c, q[t].reshape(-1, dh, 1)))
        ns.append(n)
    denom = torch.maximum(torch.einsum("tbhk,tbhk->tbh", torch.stack(ns), q).abs(),
                          torch.exp(-ms))
    h = torch.stack(hs).reshape(t_len, b, nh, dh) / denom[..., None]
    return (c, n, ms[-1]), h


def mlstm_seq(p: MLSTM, x, *, n_heads: int):
    """x (B,S,d) → (B,S,d): the recurrent mLSTM over S."""
    b, s, d = x.shape
    dh = d // n_heads
    q, k, v = _mlstm_qkv(p, x, n_heads)
    i_pre, f_pre = _mlstm_gates(p, x)
    xs = tuple(a.float().transpose(0, 1).contiguous() for a in (q, k, v, i_pre, f_pre))
    st = mlstm_init_state(b, n_heads, dh, device=x.device)
    _, hs = _chunked_scan(_mlstm_scan, (st["c"].reshape(b * n_heads, dh, dh), st["n"], st["m"]),
                          xs, s)
    h = hs.transpose(0, 1).reshape(b, s, d).to(x.dtype)
    return _gated_out(x, h, p.ogate, p.wo)


def mlstm_seq_chunked(p: MLSTM, x, *, n_heads: int, chunk: int = 64):
    """The chunkwise-parallel stabilized mLSTM: the state only at chunk
    boundaries, the interactions within a chunk as (W×dh)·(dh×W)
    products under a log-space decay mask.  The same function as
    :func:`mlstm_seq`."""
    b, s, d = x.shape
    nh = n_heads
    dh = d // nh
    w = min(chunk, s)
    if s % w:
        raise ValueError(f"mlstm_seq_chunked: sequence length {s} is not a multiple of the "
                         f"chunk {w}")
    nc = s // w
    q, k, v = _mlstm_qkv(p, x, n_heads)
    i_pre, f_pre = _mlstm_gates(p, x)                       # (B,S,H) f32

    def cview(a):     # (nc, B, H, W, dh) / (nc, B, H, W)
        if a.dim() == 4:
            return a.reshape(b, nc, w, nh, -1).permute(1, 0, 3, 2, 4)
        return a.reshape(b, nc, w, nh).permute(1, 0, 3, 2)

    qc, kc, vc = cview(q.float()), cview(k.float()), cview(v.float())
    ic, fc = cview(i_pre), cview(f_pre)
    tri = torch.ones((w, w), dtype=torch.bool, device=x.device).tril()
    f32 = dict(dtype=torch.float32, device=x.device)
    c_hat = torch.zeros((b, nh, dh, dh), **f32)             # C·e^{-m}
    n_hat = torch.zeros((b, nh, dh), **f32)
    m = torch.full((b, nh), M_INIT, **f32)
    hs = []
    for j in range(nc):
        qw, kw, vw, iw, fw = qc[j], kc[j], vc[j], ic[j], fc[j]      # (B,H,W,*)
        csum = fw.cumsum(-1)                                # F_t within the chunk
        ftot = csum[..., -1:]                               # (B,H,1)
        # D[t,τ] = F_t − F_τ + i_τ (τ ≤ t), else −1e30
        dmat = torch.where(tri, csum[..., :, None] - csum[..., None, :] + iw[..., None, :],
                           M_INIT)
        m_inter = m[..., None] + csum                       # (B,H,W)
        m_t = torch.maximum(dmat.amax(-1), m_inter)
        sw = (qw @ kw.transpose(-1, -2)) * torch.where(tri, torch.exp(dmat - m_t[..., None]),
                                                       0.0)
        lam = torch.exp(m_inter - m_t)
        inter = (qw @ c_hat.transpose(-1, -2)) * lam[..., None]
        inter_n = torch.einsum("bhk,bhtk->bht", n_hat, qw) * lam
        denom = torch.maximum((inter_n + sw.sum(-1)).abs(), torch.exp(-m_t))
        hs.append((inter + sw @ vw) / denom[..., None])
        # the boundary state
        m_new = torch.maximum(m + ftot[..., 0], (ftot - csum + iw).amax(-1))
        wgt = torch.exp(ftot - csum + iw - m_new[..., None])          # (B,H,W)
        decay = torch.exp(m + ftot[..., 0] - m_new)
        c_hat = decay[..., None, None] * c_hat + (vw * wgt[..., None]).transpose(-1, -2) @ kw
        n_hat = decay[..., None] * n_hat + torch.einsum("bht,bhtk->bhk", wgt, kw)
        m = m_new
    hseq = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(b, s, d).to(x.dtype)
    return _gated_out(x, hseq, p.ogate, p.wo)


def mlstm_step(p: MLSTM, x, state: dict, *, n_heads: int):
    """x (B,1,d), one-token decode; ``state`` the :func:`mlstm_init_state`
    dict.  Returns (out (B,1,d), the next state)."""
    b, _, d = x.shape
    q, k, v = _mlstm_qkv(p, x, n_heads)
    i_pre, f_pre = _mlstm_gates(p, x)
    state, h = _mlstm_cell(state, q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                           i_pre[:, 0], f_pre[:, 0])
    return _gated_out(x, h.reshape(b, 1, d).to(x.dtype), p.ogate, p.wo), state


# ======================================================================
# sLSTM: scalar memory, per-head recurrent connection (xLSTM)
# ======================================================================


class SLSTM(nn.Module):
    """The reference's ``init_slstm``: ``wz``, ``wo_gate``, ``wo`` (d,d);
    the gates ``wi``, ``wf`` (d,H) at scale 0.01, the recurrent ``rz``
    (H,dh,dh) at scale 0.1 and the biases ``bf`` = 3, ``bi`` = 0, all five
    float32."""

    def __init__(self, d_model: int, n_heads: int, dtype, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        d, nh = d_model, n_heads
        dh = d // nh
        self.wz = nn.Parameter(dense_init((d, d), dtype, **kw))
        self.wi = nn.Parameter(dense_init((d, nh), torch.float32, scale=0.01, **kw))
        self.wf = nn.Parameter(dense_init((d, nh), torch.float32, scale=0.01, **kw))
        self.wo_gate = nn.Parameter(dense_init((d, d), dtype, **kw))
        self.rz = nn.Parameter(dense_init((nh, dh, dh), torch.float32, scale=0.1, **kw))
        self.bf = nn.Parameter(torch.full((nh,), 3.0, **f32))
        self.bi = nn.Parameter(torch.zeros(nh, **f32))
        self.wo = nn.Parameter(dense_init((d, d), dtype, **kw))


def slstm_init_state(batch: int, n_heads: int, dh: int, *, device=None) -> dict:
    """Zero sLSTM state, ``m`` at −1e30, float32 on ``device`` (default: the
    current card; raises without one)."""
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return dict(c=torch.zeros((batch, n_heads, dh), **f32),
                n=torch.zeros((batch, n_heads, dh), **f32),
                m=torch.full((batch, n_heads), M_INIT, **f32),
                h=torch.zeros((batch, n_heads, dh), **f32))


def _slstm_cell(p: SLSTM, state, z_in, i_pre, f_pre):
    c, n, m, h_prev = state["c"], state["n"], state["m"], state["h"]
    z = torch.tanh(z_in + torch.einsum("bhk,hkj->bhj", h_prev, p.rz))
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)[..., None]
    f_g = torch.exp(f_pre + m - m_new)[..., None]
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h = c / torch.clamp_min(n, 1e-6)
    return dict(c=c, n=n, m=m_new, h=h), h


def _slstm_scan(state, xs, rz):
    """The sLSTM recurrence over time-major, heads-first z_in (T,H,B,dh)
    and gate pre-activations (T,H,B), float32; the state is (c, n, m, h)
    heads-first, so the recurrent product is one batched matmul."""
    c, n, m, h = state
    z_in, i_pre, f_pre = xs
    i_g, f_g, ms = _stabilised_gates(i_pre, f_pre, m)
    i_g, f_g = i_g[..., None], f_g[..., None]               # (T,H,B,1)
    hs = []
    for t in range(z_in.shape[0]):
        z = torch.tanh(torch.baddbmm(z_in[t], h, rz))
        c = torch.addcmul(f_g[t] * c, i_g[t], z)
        n = torch.addcmul(i_g[t], f_g[t], n)
        h = c / torch.clamp_min(n, 1e-6)
        hs.append(h)
    return (c, n, ms[-1], h), torch.stack(hs)


def _slstm_inputs(p: SLSTM, x, n_heads: int):
    """z_in (B,S,H,dh) in x's dtype and the gate pre-activations (B,S,H)
    float32."""
    b, s, d = x.shape
    x32 = x.float()
    return ((x @ p.wz).reshape(b, s, n_heads, d // n_heads), x32 @ p.wi + p.bi,
            x32 @ p.wf + p.bf)


def slstm_seq(p: SLSTM, x, *, n_heads: int):
    """x (B,S,d) → (B,S,d): the recurrent sLSTM over S."""
    b, s, d = x.shape
    z_in, i_pre, f_pre = _slstm_inputs(p, x, n_heads)
    xs = (z_in.float().permute(1, 2, 0, 3).contiguous(), i_pre.permute(1, 2, 0).contiguous(),
          f_pre.permute(1, 2, 0).contiguous())
    st = slstm_init_state(b, n_heads, d // n_heads, device=x.device)
    st = tuple(st[k].transpose(0, 1).contiguous() for k in ("c", "n", "m", "h"))
    _, hs = _chunked_scan(_slstm_scan, st, xs, s, p.rz)   # (S,H,B,dh)
    h = hs.permute(2, 0, 1, 3).reshape(b, s, d).to(x.dtype)
    return _gated_out(x, h, p.wo_gate, p.wo)


def slstm_step(p: SLSTM, x, state: dict, *, n_heads: int):
    """x (B,1,d), one-token decode; ``state`` the :func:`slstm_init_state`
    dict.  Returns (out (B,1,d), the next state)."""
    b, _, d = x.shape
    z_in, i_pre, f_pre = _slstm_inputs(p, x, n_heads)
    state, h = _slstm_cell(p, state, z_in[:, 0].float(), i_pre[:, 0], f_pre[:, 0])
    return _gated_out(x, h.reshape(b, 1, d).to(x.dtype), p.wo_gate, p.wo), state
