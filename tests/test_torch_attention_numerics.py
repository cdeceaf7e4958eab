"""The precision schemes of the bf16 ``flash_attention`` kernels, emulated
in plain torch on the CPU and held against the reference.

The forward (``src/repro_torch/csrc/flash_attention.cu``) multiplies bf16 q
and k exactly and sums in float32, scales the scores in float32, runs the
online softmax over tiles of 128 keys, and splits P into two bf16 terms,
P_hi = bf16(P) and P_lo = bf16(P - P_hi), before the PV product on the
tensor cores; the output is rounded to bf16.  The check it is held to on
the card is |out - want| <= 1e-4 + 2^-8 |want| against the float32 result
(``chip_smoke.ATTN_TOL``).  The emulation with the split meets that limit,
held against the Pallas kernel in interpret mode; with P as one bf16 term
it does not, which is why the kernel splits P.

The backward (``src/repro_torch/csrc/flash_attention_bwd.cu``) multiplies
bf16 operands exactly and sums in float32, takes Delta from the forward's
bf16 output, rounds P and dS to bf16 before their products, and rounds
the gradients to bf16.  The check on the card is a relative L2 error of
at most 1e-2 per gradient against the float32 result
(``chip_smoke.BWD_BF16_REL``); the emulation is held to it against
``jax.vjp`` of the reference's ``_sdpa`` in float32 on the same bf16 inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn_tile import flash_attention as p_flash
from repro.models import attention as r_attention
from repro_torch.kernels import ref

BK = 128                   # keys per tile, as the kernel's K/V ring holds them
NEG = -1e30
LOG2E = 1.4426950408889634
TOL = dict(rtol=2**-8, atol=1e-4)
#: the backward's check on the card: relative L2 error of each gradient
BWD_REL = 1e-2


def emulate(q, k, v, *, causal, split=True):
    """The bf16 kernel's arithmetic: q (B,H,S_q,D), k, v (B,H_kv,S_k,D)
    bf16 → (B,H,S_q,D) bf16."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * LOG2E   # a float32 product
    rows = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), NEG)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, BK):
        cols = torch.arange(k0, min(k0 + BK, sk))[None, :]
        # bf16 products are exact in float32; the sums are float32
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf[:, :, k0:k0 + BK]) * scale_log2
        if causal:
            s = torch.where(cols <= rows + (sk - sq), s, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(s > NEG / 2, torch.exp2(s - m_new), 0.0)
        alpha = torch.exp2(torch.clamp(m - m_new, max=0.0))
        l = alpha * l + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        terms = (p_hi, (p - p_hi).bfloat16().float()) if split else (p_hi,)
        acc = acc * alpha
        for term in terms:
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", term, vf[:, :, k0:k0 + BK])
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _share(got, want):
    """The largest share of TOL that ``got`` uses against ``want``."""
    diff = np.abs(got.float().numpy() - want)
    return float((diff / (TOL["atol"] + TOL["rtol"] * np.abs(want))).max())


CASES = [  # b, h, h_kv, s_q, s_k, d, causal
    (1, 2, 2, 512, 512, 128, True),
    (1, 4, 2, 256, 256, 64, True),      # GQA: two heads read each K/V head
    (1, 2, 2, 256, 256, 128, False),
    (1, 2, 2, 384, 128, 64, True),      # S_q > S_k: the first 256 rows see no key
]


def _inputs(b, h, h_kv, sq, sk, d):
    rng = np.random.default_rng(sq * 31 + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((b, h, sq, d), (b, h_kv, sk, d), (b, h_kv, sk, d)))
    return q, k, v


def _pallas(q, k, v, causal):
    """The Pallas kernel in interpret mode on the bf16 values as float32:
    its float32 result, with K/V repeated to the query heads."""
    group = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(group, dim=1) for t in (k, v))
    out = p_flash(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)), causal=causal,
                  interpret=True)
    return np.array(out)


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal", CASES)
def test_split_p_meets_the_bf16_check_and_one_bf16_term_does_not(b, h, h_kv, sq, sk, d,
                                                                  causal):
    q, k, v = _inputs(b, h, h_kv, sq, sk, d)
    want = _pallas(q, k, v, causal)
    got = emulate(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _share(got, want) <= 1.0
    if causal and sq > sk:
        assert bool((got[:, :, :sq - sk] == 0).all())
    single = emulate(q, k, v, causal=causal, split=False)
    assert _share(single, want) > 1.0


def test_split_p_within_rounding_of_float32_p():
    # the split leaves P's error below 2^-16 of P, so the output differs
    # from the float32-P arithmetic by at most a bf16 rounding step
    q, k, v = _inputs(1, 2, 2, 256, 256, 128)
    split = emulate(q, k, v, causal=True).float()
    exact = torch.from_numpy(_pallas(q, k, v, True)).bfloat16().float()
    np.testing.assert_allclose(split.numpy(), exact.numpy(), rtol=2**-7, atol=1e-4)


def emulate_bwd(q, k, v, dout, *, causal, bf16_p=True):
    """The bf16 backward kernel's arithmetic: q, dout (B,H,S_q,D), k, v
    (B,H_kv,S_k,D) bf16 → (dq, dk, dv) bf16.  ``bf16_p=False`` keeps P and
    dS in float32 (the float32 arithmetic on the same bf16 inputs)."""
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    group = h // h_kv
    qf, gf = q.float(), dout.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale = d ** -0.5
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E   # a float32 product
    # the forward's float32 lse (+inf on a row with no visible key), and Delta
    # from the forward's bf16 output
    _, lse = ref.attention_fwd_ref(qf, k.float(), v.float(), causal=causal)
    delta = (gf * emulate(q, k, v, causal=causal).float()).sum(-1, keepdim=True)
    # bf16 products are exact in float32; the sums are float32
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp2(s * scale_log2 - (lse * LOG2E)[..., None])
    if causal:
        rows, cols = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
        p = torch.where(cols <= rows + (sk - sq), p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta)
    if bf16_p:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()

    def fold(t):   # the GQA group's heads summed onto their K/V head
        return t.reshape(b, h_kv, group, sk, d).sum(2)

    dv = fold(torch.einsum("bhqk,bhqd->bhkd", p, gf))
    dk = fold(torch.einsum("bhqk,bhqd->bhkd", ds, qf)) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _sdpa_vjp(q, k, v, dout, causal):
    """Gradients of the reference's ``_sdpa`` in float32 on the bf16 values.
    It gives a row with no visible key uniform weights where the port gives
    it 0, so that row's dout is taken as 0 here: the port sends nothing from
    it whatever its dout."""
    sq, sk = q.shape[2], k.shape[2]
    if causal and sq > sk:
        dout = dout.clone()
        dout[:, :, :sq - sk] = 0

    def sdpa(q, k, v):   # the reference's (B,S,H,D) layout, suffix-aligned
        out = r_attention._sdpa(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                                v.transpose(0, 2, 1, 3), causal=causal, window=0,
                                q_pos0=sk - sq if causal else 0)
        return out.transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(sdpa, *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout.float().numpy()))]


def _rel(got, want):
    return float(np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want))


BWD_CASES = [  # b, h, h_kv, s_q, s_k, d, causal
    (1, 4, 1, 200, 200, 64, True),      # GQA group of 4, S ragged against the 64-row tiles
    (1, 2, 2, 150, 333, 128, True),     # ragged S_q < S_k
    (1, 4, 2, 256, 128, 64, True),      # S_q > S_k: the first 128 rows see no key
    (1, 2, 2, 256, 256, 128, False),
]


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal", BWD_CASES)
def test_bwd_bf16_p_and_ds_meet_the_check_against_jax_vjp(b, h, h_kv, sq, sk, d, causal):
    q, k, v = _inputs(b, h, h_kv, sq, sk, d)
    dout = _inputs(b, h, h_kv, sq, sk, d + 1)[0][..., :d].contiguous()
    got = emulate_bwd(q, k, v, dout, causal=causal)
    want = _sdpa_vjp(q, k, v, dout, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= BWD_REL, (name, _rel(g, w))
    if causal and sq > sk:
        assert bool((got[0][:, :, :sq - sk] == 0).all())


def test_bwd_bf16_p_and_ds_add_less_than_the_float32_arithmetics_error():
    # rounding P and dS to bf16 adds to the float32 arithmetic's error (the
    # bf16 inputs and outputs) less than as much again
    q, k, v = _inputs(1, 2, 2, 256, 256, 128)
    dout = _inputs(1, 2, 2, 256, 256, 129)[0][..., :128].contiguous()
    want = _sdpa_vjp(q, k, v, dout, True)
    bf16 = emulate_bwd(q, k, v, dout, causal=True)
    f32 = emulate_bwd(q, k, v, dout, causal=True, bf16_p=False)
    for g, g32, w in zip(bf16, f32, want):
        assert _rel(g32, w) < _rel(g, w) < 2 * _rel(g32, w)
