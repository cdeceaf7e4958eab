"""The precision scheme of the bf16 ``flash_attention`` kernel
(``src/repro_torch/csrc/flash_attention.cu``), emulated in plain torch on
the CPU and held against the Pallas kernel in interpret mode.

The kernel multiplies bf16 q and k exactly and sums in float32, scales the
scores in float32, runs the online softmax over tiles of 128 keys, and
splits P into two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
before the PV product on the tensor cores; the output is rounded to bf16.
The check it is held to on the card is |out - want| <= 1e-4 + 2^-8 |want|
against the float32 result (``chip_smoke.ATTN_TOL``).  The emulation with
the split meets that limit; with P as one bf16 term it does not, which is
why the kernel splits P.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn_tile import flash_attention as p_flash

BK = 128                   # keys per tile, as the kernel's K/V ring holds them
NEG = -1e30
LOG2E = 1.4426950408889634
TOL = dict(rtol=2**-8, atol=1e-4)


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
