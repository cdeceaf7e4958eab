"""The port's CUDA kernels and algorithms on a card, against the port's
plain versions and its CPU runs.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when
no card is present.  This file imports no jax, so it runs where only
PyTorch is installed::

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports the JAX package.)
"""
import copy

import numpy as np
import pytest
import torch

from dataclasses import replace

from repro_torch.algorithms import (
    afforest_algorithm, bfs_algorithm, hits_algorithm, kcore_algorithm,
    pagerank_algorithm, sv_algorithm, tc_algorithm,
)
from repro_torch.algorithms.tc import orient_dag
from repro_torch.core import (
    build_block_store, build_schedule, compile_plan, degree_order, rmat, task_footprints,
)
from repro_torch.kernels import ref, registry
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_cuda,
)
from repro_torch.kernels.frontier_tiles import frontier_tiles
from repro_torch.kernels.spmv_ell import spmv_ell
from repro_torch.kernels.spmv_tiles import spmv_tiles
from repro_torch.kernels.tc_tiles import tc_tiles
from repro_torch.models import lm
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw_init
from repro_torch.serve import GraphServer, Query, Request, ServeEngine

pytestmark = pytest.mark.gpu

INT_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _tiles(rng, nb, t, density):
    return (rng.random((nb, t, t)) < density).astype(np.float32)


@pytest.mark.parametrize("nb,t", [(1, 128), (4, 128), (2, 256), (3, 192), (5, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_tiles_cuda_vs_plain(cuda, nb, t, dtype):
    rng = np.random.default_rng(nb * 1000 + t)
    tiles = torch.from_numpy(_tiles(rng, nb, t, 0.1)).to(cuda, dtype)
    xs = torch.from_numpy(rng.random((nb, t)).astype(np.float32)).to(cuda, dtype)
    before = registry.launch_counts()["spmv_tiles"]
    got = spmv_tiles(tiles, xs)
    assert registry.launch_counts()["spmv_tiles"] == before + 1
    torch.testing.assert_close(got, ref.spmv_tiles_ref(tiles, xs), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nb,t", [(1, 128), (4, 128), (1, 512), (2, 192), (1, 96),
                                  (2, 160), (1, 48)])
@pytest.mark.parametrize("fdtype", [torch.bool, torch.float32])
def test_frontier_tiles_cuda_vs_plain(cuda, nb, t, fdtype):
    rng = np.random.default_rng(nb * 1000 + t)
    tiles = torch.from_numpy(_tiles(rng, nb, t, 0.05)).to(cuda)
    f = torch.from_numpy(rng.random((nb, t)) < 0.3).to(cuda, fdtype)
    got = frontier_tiles(tiles, f)
    assert torch.equal(got, ref.frontier_tiles_ref(tiles, f))


def test_frontier_tiles_cuda_empty_frontier(cuda):
    tiles = torch.from_numpy(_tiles(np.random.default_rng(0), 2, 128, 0.05)).to(cuda)
    got = frontier_tiles(tiles, torch.zeros((2, 128), dtype=torch.bool, device=cuda))
    assert bool((got == INT_MAX).all())


@pytest.mark.parametrize("nd,nb,t", [(3, 1, 128), (6, 3, 128), (4, 2, 256),
                                     (5, 7, 192), (3, 2, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tc_tiles_cuda_vs_plain(cuda, nd, nb, t, dtype):
    rng = np.random.default_rng(nd * 1000 + t)
    tiles = torch.from_numpy(_tiles(rng, nd, t, 0.05)).to(cuda, dtype)
    idx = rng.integers(0, nd, (nb, 3)).astype(np.int32)
    idx[-1] = -1                               # a masked (padding) triple
    idx = torch.from_numpy(idx).to(cuda)
    got = tc_tiles(tiles, idx)
    assert got.dtype == torch.int64
    assert int(got) == int(ref.tc_tiles_idx_ref(tiles, idx))


#: tile sides and types for the extents cases: the TMA route at T in {64, 192,
#: 512}, and the cp.async route where the row stride is not 16-byte aligned
#: (T*4 or T*2 bytes), including a bf16 T whose rows are not 4-byte aligned
EXTENT_CASES = [(64, torch.float32), (192, torch.float32), (512, torch.float32),
                (64, torch.bfloat16), (192, torch.bfloat16), (512, torch.bfloat16),
                (50, torch.float32), (36, torch.bfloat16), (37, torch.bfloat16)]


#: extents of the ragged rectangles besides T (clamped to T): a width of each
#: power-of-two lane group of spmv_tiles' routes (V = 1, 4 or 8 columns a lane,
#: 1 to 256 lanes), and 300, a rectangle whose second 256-column panel is ragged
EXTENT_CHOICES = (0, 1, 3, 7, 13, 30, 63, 65, 100, 200, 300)


def _ragged(rng, nd, t, density, cuda, dtype):
    """0/1 tiles zeroed outside random extents that include 0 and T: rows
    drawn from EXTENT_CHOICES and T, columns cycling through them from a
    random start (2 + 12 k tiles take each width k times)."""
    tiles = _tiles(rng, nd, t, density)
    choices = np.minimum([*EXTENT_CHOICES, t], t).astype(np.int32)
    rows = rng.choice(choices, nd)
    cols = choices[(np.arange(nd) + rng.integers(len(choices))) % len(choices)]
    rows[:2], cols[:2] = (0, t), (t, 0)
    for n in range(nd):
        tiles[n, rows[n]:] = 0
        tiles[n, :, cols[n]:] = 0
    return (torch.from_numpy(tiles).to(cuda, dtype),
            (torch.from_numpy(rows).to(cuda), torch.from_numpy(cols).to(cuda)))


@pytest.mark.parametrize("t,dtype", EXTENT_CASES)
def test_tc_tiles_cuda_with_extents_vs_plain(cuda, t, dtype):
    rng = np.random.default_rng(t)
    tiles, extents = _ragged(rng, 9, t, 0.2, cuda, dtype)
    idx = rng.integers(0, 9, (201, 3)).astype(np.int32)
    idx[::5] = -1                              # masked (padding) triples
    idx = torch.from_numpy(idx).to(cuda)
    want = int(ref.tc_tiles_idx_ref(tiles, idx))
    before = registry.launch_counts()["tc_tiles"]
    assert int(tc_tiles(tiles, idx, extents)) == want
    assert int(tc_tiles(tiles, idx)) == want   # extents=None: whole tiles
    assert registry.launch_counts()["tc_tiles"] == before + 2


@pytest.mark.parametrize("t,dtype", EXTENT_CASES)
@pytest.mark.parametrize("fdtype", [torch.bool, torch.float32, torch.bfloat16])
def test_frontier_tiles_cuda_with_extents_vs_plain(cuda, t, dtype, fdtype):
    rng = np.random.default_rng(t)
    tiles, extents = _ragged(rng, 9, t, 0.05, cuda, dtype)
    f = torch.from_numpy(rng.random((9, t)) < 0.3).to(cuda, fdtype)
    want = ref.frontier_tiles_ref(tiles, f)
    assert torch.equal(frontier_tiles(tiles, f, extents), want)
    assert torch.equal(frontier_tiles(tiles, f), want)
    empty = frontier_tiles(tiles, torch.zeros_like(f), extents)
    assert bool((empty == INT_MAX).all())


@pytest.mark.parametrize("t", [64, 100, 192, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_tiles_cuda_with_extents_vs_plain(cuda, t, dtype):
    rng = np.random.default_rng(t)
    tiles, extents = _ragged(rng, 26, t, 0.2, cuda, dtype)     # every width twice
    xs = torch.from_numpy(rng.random((26, t)).astype(np.float32)).to(cuda, dtype)
    want = ref.spmv_tiles_ref(tiles, xs)
    before = registry.launch_counts()["spmv_tiles"]
    got = spmv_tiles(tiles, xs, extents)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    past = torch.arange(t, device=cuda)[None, :] >= extents[1][:, None]
    assert bool((got[past] == 0).all())        # exact zeros past each rectangle's columns
    torch.testing.assert_close(spmv_tiles(tiles, xs), want, rtol=1e-5, atol=1e-6)
    assert registry.launch_counts()["spmv_tiles"] == before + 2


#: query counts of the batched launches: one group of each template width
#: (1, 2, 4, 8 queries) and 9, which spills into a second group
QUERY_COUNTS = (1, 2, 3, 8, 9)


@pytest.mark.parametrize("q", QUERY_COUNTS)
@pytest.mark.parametrize("t", [64, 100, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_tiles_cuda_query_axis(cuda, q, t, dtype):
    rng = np.random.default_rng(q * 1000 + t)
    tiles, extents = _ragged(rng, 26, t, 0.2, cuda, dtype)
    xs = torch.from_numpy(rng.random((q, 26, t)).astype(np.float32)).to(cuda, dtype)
    before = registry.launch_counts()["spmv_tiles"]
    got = spmv_tiles(tiles, xs, extents)
    assert registry.launch_counts()["spmv_tiles"] == before + 1
    assert got.shape == (q, 26, t)
    torch.testing.assert_close(got, ref.spmv_tiles_ref(tiles, xs), rtol=1e-5, atol=1e-6)
    for i in range(q):      # each row is the Q = 1 launch on that row, bit for bit
        assert torch.equal(got[i], spmv_tiles(tiles, xs[i], extents))


@pytest.mark.parametrize("q", QUERY_COUNTS)
@pytest.mark.parametrize("t,dtype", [(64, torch.float32), (192, torch.bfloat16),
                                     (512, torch.float32), (50, torch.float32)])
def test_frontier_tiles_cuda_query_axis(cuda, q, t, dtype):
    rng = np.random.default_rng(q * 1000 + t)
    tiles, extents = _ragged(rng, 9, t, 0.05, cuda, dtype)
    f = torch.from_numpy(rng.random((q, 9, t)) < 0.3).to(cuda)
    f[q // 2] = False                          # one query with an empty frontier
    before = registry.launch_counts()["frontier_tiles"]
    got = frontier_tiles(tiles, f, extents)
    assert registry.launch_counts()["frontier_tiles"] == before + 1
    assert torch.equal(got, ref.frontier_tiles_ref(tiles, f))
    assert bool((got[q // 2] == INT_MAX).all())
    for i in range(q):
        assert torch.equal(got[i], frontier_tiles(tiles, f[i], extents))


def test_spmv_tiles_cuda_misaligned_tiles_take_the_scalar_route(cuda):
    rng = np.random.default_rng(3)
    tiles = torch.from_numpy(_tiles(rng, 3, 64, 0.2)).to(cuda)
    buf = tiles.new_zeros(tiles.numel() + 1)
    buf[1:] = tiles.reshape(-1)
    view = buf[1:].view(3, 64, 64)             # one element in: rows not 16-byte aligned
    assert view.data_ptr() % 16 != 0
    xs = torch.from_numpy(rng.random((3, 64)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(spmv_tiles(view, xs), ref.spmv_tiles_ref(tiles, xs),
                               rtol=1e-5, atol=1e-6)


def test_spmv_tiles_cuda_empty_batch(cuda):
    got = spmv_tiles(torch.zeros((0, 64, 64), device=cuda), torch.zeros((0, 64), device=cuda))
    assert got.shape == (0, 64) and got.dtype == torch.float32


def test_tc_tiles_cuda_checks_live_triples_only(cuda):
    tiles = torch.zeros((3, 64, 64), device=cuda)
    masked = torch.tensor([[-1, 7, -5], [0, 1, 2]], dtype=torch.int32, device=cuda)
    assert int(tc_tiles(tiles, masked)) == 0     # a masked triple may hold anything
    for bad in ([0, 1, 3], [2, -1, 0]):
        with pytest.raises(IndexError, match="outside"):
            tc_tiles(tiles, torch.tensor([bad], dtype=torch.int32, device=cuda))


def test_tile_kernels_reject_extents_on_another_device(cuda):
    tiles = torch.zeros((2, 8, 8), device=cuda)
    rows = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="extents"):
        tc_tiles(tiles, torch.zeros((1, 3), dtype=torch.int32, device=cuda), (rows, rows))
    with pytest.raises(ValueError, match="extents"):
        frontier_tiles(tiles, torch.zeros((2, 8), device=cuda), (rows, rows))


ATTN_CASES = [  # b, h, h_kv, s_q, s_k, d, causal
    (1, 2, 2, 128, 128, 64, True), (2, 4, 1, 128, 256, 64, True), (1, 2, 2, 256, 256, 128, False),
    (1, 4, 2, 256, 128, 128, True),          # S_q > S_k: the first 128 rows see no key
    (2, 6, 3, 100, 77, 64, True),            # ragged ends on both axes
    (1, 8, 2, 300, 300, 128, False),
    (1, 4, 1, 2048, 2048, 128, True),        # many K/V ring stages, the prefill's GQA group of 4
    (1, 8, 2, 1000, 1000, 128, True)]        # ragged at D=128


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_vs_plain(cuda, b, h, h_kv, sq, sk, d, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((b, h, sq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, h_kv, sk, d), generator=gen, device=cuda).to(dtype) for _ in "kv")
    before = registry.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    assert registry.launch_counts()["flash_attention"] == before + 1
    # against the plain version's float32 result, before its cast: f32 is
    # the same arithmetic summed in another order (the reference's 2e-4);
    # a bf16 output adds its rounding, at most half a step (2^-8 of the value)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 else dict(rtol=2**-8, atol=1e-4)
    torch.testing.assert_close(got.float(), want, **tol)
    if causal and sq > sk:
        assert bool((got[:, :, :sq - sk] == 0).all())


def test_flash_attention_cuda_rejects_a_misaligned_tensor(cuda):
    # TMA reads from 16-byte aligned addresses: a view one element in raises
    q = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(1, 2, 128, 64)
    k = torch.zeros((1, 2, 128, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, k)


#: the backward's shapes: those of the forward, among them the two with many ring
#: stages (S = 2048 with a GQA group of 4, and S = 1000 ragged at D = 128), and one
#: with S not a multiple of 64 on either axis
BWD_CASES = ATTN_CASES + [(1, 4, 2, 200, 333, 64, True)]


def _attn_inputs(cuda, b, h, h_kv, sq, sk, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + sk + d)
    q, dout = (torch.randn((b, h, sq, d), generator=gen, device=cuda).to(dtype) for _ in "qg")
    k, v = (torch.randn((b, h_kv, sk, d), generator=gen, device=cuda).to(dtype) for _ in "kv")
    return q, k, v, dout


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_cuda_vs_plain(cuda, b, h, h_kv, sq, sk, d, causal, dtype):
    q, k, v, dout = _attn_inputs(cuda, b, h, h_kv, sq, sk, d, dtype)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    before = registry.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    assert registry.launch_counts()["flash_attention_bwd"] == before + 1
    w_out, w_lse = ref.attention_fwd_ref(q.float(), k.float(), v.float(), causal=causal)
    want = ref.attention_bwd_ref(q.float(), k.float(), v.float(), w_out, w_lse, dout.float(),
                                 causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        if dtype == torch.float32:   # the same sums in another order (LM_TOL)
            torch.testing.assert_close(g, w, rtol=1e-3, atol=2e-4)
        else:                        # bf16 products, P and dS rounded to bf16, bf16 output
            assert float((g.float() - w).norm() / w.norm()) <= 1e-2
    if causal and sq > sk:
        assert bool((got[0][:, :, :sq - sk] == 0).all())


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_on_both_routes(cuda, b, h, h_kv, sq, sk, d, causal, dtype):
    q, k, v, _ = _attn_inputs(cuda, b, h, h_kv, sq, sk, d, dtype)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal))
    _, want = ref.attention_fwd_ref(q.float(), k.float(), v.float(), causal=causal)
    empty = torch.isinf(want)
    assert lse.dtype == torch.float32 and torch.equal(torch.isinf(lse), empty)
    assert bool((lse[empty] > 0).all())
    torch.testing.assert_close(lse[~empty], want[~empty], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_gives_the_same_bits_twice(cuda, dtype):
    q, k, v, dout = _attn_inputs(cuda, 1, 8, 2, 1000, 1000, 128, dtype)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, dout)
    second = flash_attention_bwd(q, k, v, out, lse, dout)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_bwd_bf16_same_bits_twice_over_many_tiles(cuda):
    # 16 key tiles of dK/dV and 16 query tiles of dQ a head, each walking a ring of many stages
    q, k, v, dout = _attn_inputs(cuda, 2, 16, 4, 2048, 2048, 128, torch.bfloat16)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, dout)
    second = flash_attention_bwd(q, k, v, out, lse, dout)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_bwd_cuda_rejects_a_misaligned_tensor(cuda):
    # the bf16 route reads q, k, v and dout with TMA: a view one element in raises
    q, k, v, dout = _attn_inputs(cuda, 1, 2, 2, 128, 128, 64, torch.bfloat16)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    shifted = torch.zeros(dout.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:]
    shifted = shifted.view(dout.shape)
    shifted.copy_(dout)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, k, v, out, lse, shifted)


def test_flash_attention_fn_launches_both_kernels_on_the_card(cuda):
    q, k, v, dout = _attn_inputs(cuda, 1, 4, 2, 256, 256, 64, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    registry.reset_launch_counts()
    out = flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, dout)
    counts = registry.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*plain), plain, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=2e-4)


def test_train_step_kernel_vs_plain_on_the_card(cuda):
    # d_head 128 at S = 128 passes the kernel guard; float32, TF32 off (the default)
    cfg = replace(get_smoke("granite-3-8b"), d_model=256, n_heads=2, n_kv_heads=1,
                  dtype="float32")
    base = lm.LM(cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 128), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    batch = dict(tokens=tokens, labels=tokens.roll(-1, 1))
    runs = {}
    for use_kernel in (True, False):
        model = copy.deepcopy(base)
        opt = adamw_init(model)
        registry.reset_launch_counts()
        opt, m = make_train_step(cfg, warmup_steps=1, use_kernel=use_kernel)(model, opt, batch, 0)
        runs[use_kernel] = model, opt, m, registry.launch_counts()
    (km, _, kmet, kl), (pm, popt, pmet, pl) = runs[True], runs[False]
    assert (kl["flash_attention"], kl["flash_attention_bwd"]) == (2 * cfg.n_layers, cfg.n_layers)
    assert (pl["flash_attention"], pl["flash_attention_bwd"]) == (0, 0)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(kmet[key], pmet[key], rtol=1e-3, atol=2e-4)
    with torch.no_grad():   # the reference's resume tolerance; 0 < |g| < 1e-6: Adam's steep region
        for (name, a), b in zip(km.named_parameters(), pm.parameters()):
            mu = popt["mu"][name].abs()
            tiny = (mu < 1e-7) & (mu > 0)
            limit = torch.where(tiny, 2 * kmet["lr"], 1e-5 + 1e-4 * b.abs())
            assert bool(((a - b).abs() <= limit).all()), name


#: (B, R, K, N): K a multiple of 4 takes the int4 route (K = 4: one lane a row;
#: K = 32: 8; K = 100: 32 lanes, each over several chunks), any other K the
#: scalar one (K = 7, 13, 33)
ELL_CASES = [(1, 128, 8, 256), (3, 200, 7, 500), (2, 1000, 32, 4096), (2, 300, 13, 1000),
             (1, 513, 32, 2048), (2, 100, 4, 64), (1, 50, 100, 300), (2, 77, 33, 999)]


@pytest.mark.parametrize("b,r,k,n", ELL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_ell_cuda_vs_plain(cuda, b, r, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(r)
    idx = torch.randint(0, n, (b, r, k), generator=gen, device=cuda, dtype=torch.int32)
    valid = torch.rand((b, r, k), generator=gen, device=cuda) < 0.7
    x = torch.rand((b, n), generator=gen, device=cuda).to(dtype)
    before = registry.launch_counts()["spmv_ell"]
    got = spmv_ell(idx, valid, x)
    assert registry.launch_counts()["spmv_ell"] == before + 1
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), ref.spmv_ell_ref(idx, valid, x).float(), **tol)


def test_spmv_ell_cuda_misaligned_rows_take_the_scalar_route(cuda):
    # K = 32 but idx starts one element into its storage: no int4 loads
    gen = torch.Generator(device=cuda).manual_seed(5)
    idx = torch.randint(0, 100, (2 * 64 * 32 + 1,), generator=gen, device=cuda,
                        dtype=torch.int32)[1:].view(2, 64, 32)
    valid = torch.rand((2, 64, 32), generator=gen, device=cuda) < 0.5
    x = torch.rand((2, 100), generator=gen, device=cuda)
    assert idx.data_ptr() % 16 != 0
    torch.testing.assert_close(spmv_ell(idx, valid, x), ref.spmv_ell_ref(idx, valid, x),
                               rtol=1e-5, atol=1e-6)


def test_spmv_ell_cuda_skips_masked_indices(cuda):
    idx = torch.full((1, 4, 3), 10**6, dtype=torch.int32, device=cuda)
    idx[0, :, 0] = torch.arange(4, device=cuda, dtype=torch.int32)
    valid = torch.zeros((1, 4, 3), dtype=torch.bool, device=cuda)
    valid[0, :, 0] = True
    x = torch.arange(8.0, device=cuda)[None]
    assert torch.equal(spmv_ell(idx, valid, x), x[:, :4])


def _small_lm(device):
    cfg = replace(get_smoke("granite-3-8b"), d_model=256, n_heads=4, n_kv_heads=2,
                  dtype="float32")
    return cfg, lm.LM(cfg, generator=torch.Generator(device=device).manual_seed(0),
                      device=device)


def test_lm_forward_kernel_vs_plain_on_the_card(cuda):
    cfg, model = _small_lm(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    registry.reset_launch_counts()
    with torch.inference_mode():
        got = lm.forward_logits(cfg, model, dict(tokens=tokens), use_kernel=True)
        assert registry.launch_counts()["flash_attention"] == cfg.n_layers
        want = lm.forward_logits(cfg, model, dict(tokens=tokens))
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-4)


def test_serve_engine_on_the_card_equals_the_cpu(cuda):
    cfg, model = _small_lm("cpu")
    runs = {}
    for dev in ("cpu", cuda):
        eng = ServeEngine(cfg, model.to(dev), batch_slots=2, cache_len=32, device=dev)
        for uid in range(3):
            eng.submit(Request(uid=uid, prompt=[1 + uid, 5, 9], max_new_tokens=5))
        runs[str(dev)] = {r.uid: r.output for r in eng.run_until_drained()}
    assert runs["cpu"] == runs[str(cuda)]


def test_cuda_kernels_reject_cpu_tensors(cuda):
    with pytest.raises(ValueError, match="CUDA tensors"):
        registry.get_kernel("spmv_tiles", "cuda")(torch.zeros(1, 4, 4, device=cuda),
                                                  torch.zeros(1, 4))


@pytest.fixture(scope="module")
def small_store():
    g, _ = degree_order(rmat(11, 16, seed=5), ascending=False)
    return build_block_store(g, 16)


_PLAN_KW = dict(tile_dim=256, dense_density=0.001)


def test_pagerank_cuda_vs_cpu(cuda, small_store):
    cpu = compile_plan(pagerank_algorithm(), small_store, device="cpu", **_PLAN_KW).run()
    registry.reset_launch_counts()
    plan = compile_plan(pagerank_algorithm(), small_store, device=cuda, **_PLAN_KW)
    got = plan.run()
    assert plan.schedule.stats["dense_tasks"] > 0
    assert registry.launch_counts()["spmv_tiles"] == got.iterations
    # atomic float adds on the card reorder the sums: ranks agree to
    # float32 rounding, and the delta > tol test may then end the run
    # one iteration apart
    assert abs(got.iterations - cpu.iterations) <= 1
    np.testing.assert_allclose(got.result, cpu.result, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("direction", ["push", "pull", "auto"])
def test_bfs_cuda_vs_cpu(cuda, small_store, direction):
    src = int(np.argmax(small_store.degrees))
    cpu = compile_plan(bfs_algorithm(src), small_store, device="cpu",
                       direction=direction, **_PLAN_KW).run()
    registry.reset_launch_counts()
    got = compile_plan(bfs_algorithm(src), small_store, device=cuda,
                       direction=direction, **_PLAN_KW).run()
    for k in ("parent", "dist"):
        np.testing.assert_array_equal(got.result[k], cpu.result[k])
    decisions = got.schedule_stats["direction"]["decisions"]
    assert decisions == cpu.schedule_stats["direction"]["decisions"]
    pulls = decisions.count("pull")
    assert (registry.launch_counts()["frontier_tiles"] > 0) == (pulls > 0)


def test_tc_cuda_vs_cpu(cuda):
    store = build_block_store(orient_dag(rmat(11, 16, seed=5)), 8)
    cpu = compile_plan(tc_algorithm(), store, device="cpu", **_PLAN_KW).run()
    registry.reset_launch_counts()
    plan = compile_plan(tc_algorithm(), store, device=cuda, **_PLAN_KW)
    got = plan.run()
    assert plan.schedule.stats["dense_tasks"] > 0
    assert registry.launch_counts()["tc_tiles"] == 1
    assert got.result == cpu.result


# ---------------------------------------------------------------- A6
@pytest.mark.parametrize("make,kw", [
    (sv_algorithm, {}), (afforest_algorithm, {}),
    (lambda: kcore_algorithm(16), dict(mode="sparse_only"))])
@pytest.mark.parametrize("direction", ["push", "auto"])
def test_exact_algorithms_cuda_vs_cpu(cuda, small_store, make, kw, direction):
    cpu = compile_plan(make(), small_store, device="cpu", direction=direction, **kw).run()
    got = compile_plan(make(), small_store, device=cuda, direction=direction, **kw).run()
    assert got.iterations == cpu.iterations
    np.testing.assert_array_equal(got.result, cpu.result)
    assert (got.schedule_stats["direction"]["decisions"]
            == cpu.schedule_stats["direction"]["decisions"])


def test_hits_cuda_vs_cpu(cuda, small_store):
    # a negative tol runs both to max_iters (the stopping test sits at the
    # float32 noise floor)
    kw = dict(mode="sparse_only")
    cpu = compile_plan(hits_algorithm(tol=-1.0, max_iters=30), small_store, device="cpu",
                       **kw).run()
    got = compile_plan(hits_algorithm(tol=-1.0, max_iters=30), small_store, device=cuda,
                       **kw).run()
    assert got.iterations == cpu.iterations
    for k in ("hub", "auth"):
        np.testing.assert_allclose(got.result[k], cpu.result[k], rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------- A7
def _quarter_budget(alg, store, **kw):
    """A budget near a quarter of the schedule's total footprint."""
    sched = build_schedule(alg, store, **kw)
    return int(task_footprints(store, sched,
                               workspace_kernel=alg.metadata.get("workspace_kernel")).sum()) // 4


def _streamed(alg, store, cuda, budget, **kw):
    """(plan, result, peak bytes above the allocation before compile)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    registry.reset_launch_counts()
    plan = compile_plan(alg, store, device=cuda, memory_budget=budget, **kw)
    res = plan.run()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    st = res.schedule_stats["streaming"]
    assert all(b + w <= budget for b, w in zip(st["bytes_per_wave"], st["workspace_per_wave"]))
    assert peak <= plan.resident_device_bytes + (plan.pipeline_depth + 1) * budget
    _assert_no_recovery(plan)
    return plan, res


def _assert_no_recovery(plan):
    """A fault-free plan detected no failure, demoted nothing and kept
    its host lane: nothing fell back to the host's plain kernels."""
    res = plan._resil
    assert res.detected == 0 and res.demotions == 0 and res.host_failovers == 0
    assert not any(a["action"] == "host_disable" for a in res.actions)


def test_streamed_pagerank_cuda_vs_cpu(cuda, small_store):
    budget = _quarter_budget(pagerank_algorithm(), small_store, **_PLAN_KW)
    cpu = compile_plan(pagerank_algorithm(), small_store, device="cpu", **_PLAN_KW).run()
    plan, got = _streamed(pagerank_algorithm(), small_store, cuda, budget,
                          rebalance_threshold=None, **_PLAN_KW)
    dense_waves = sum(r.run_dense for r in plan._slabs)
    assert plan.num_waves >= 4 and dense_waves > 0
    # warm-up + timed pass in the first iteration, one pass after
    assert registry.launch_counts()["spmv_tiles"] == (got.iterations + 1) * dense_waves
    assert abs(got.iterations - cpu.iterations) <= 1
    np.testing.assert_allclose(got.result, cpu.result, rtol=1e-4, atol=1e-7)
    assert got.schedule_stats["streaming"]["h2d_bytes"] > 0


def test_streamed_bfs_cuda_vs_cpu(cuda, small_store):
    src = int(np.argmax(small_store.degrees))
    budget = _quarter_budget(bfs_algorithm(src), small_store, **_PLAN_KW)
    cpu = compile_plan(bfs_algorithm(src), small_store, device="cpu", direction="auto",
                       **_PLAN_KW).run()
    plan, got = _streamed(bfs_algorithm(src), small_store, cuda, budget, direction="auto",
                          **_PLAN_KW)
    assert plan.num_waves >= 4
    for k in ("parent", "dist"):
        np.testing.assert_array_equal(got.result[k], cpu.result[k])
    if "pull" in got.schedule_stats["direction"]["decisions"]:
        assert registry.launch_counts()["frontier_tiles"] > 0


def test_streamed_tc_cuda_vs_cpu(cuda):
    store = build_block_store(orient_dag(rmat(11, 16, seed=5)), 8)
    budget = _quarter_budget(tc_algorithm(), store, **_PLAN_KW)
    cpu = compile_plan(tc_algorithm(), store, device="cpu", **_PLAN_KW).run()
    plan, got = _streamed(tc_algorithm(), store, cuda, budget, **_PLAN_KW)
    assert plan.num_waves >= 2
    assert registry.launch_counts()["tc_tiles"] > 0
    assert got.result == cpu.result


# ---------------------------------------------------------------- A8, A9
@pytest.mark.parametrize("name", ["cc", "bfs"])
def test_hetero_streamed_equals_device_only(cuda, small_store, name):
    """Host units on CPU tensors beside the card's waves: the labels,
    parents, distances and direction decisions of a device-only run."""
    src = int(np.argmax(small_store.degrees))
    make, kw = dict(cc=(afforest_algorithm, dict(mode="sparse_only")),
                    bfs=(lambda: bfs_algorithm(src), dict(_PLAN_KW, direction="auto")))[name]
    budget = _quarter_budget(make(), small_store, **{k: v for k, v in kw.items()
                                                     if k != "direction"})
    _, want = _streamed(make(), small_store, cuda, budget, host_fraction=None, **kw)
    plan, got = _streamed(make(), small_store, cuda, budget, host_fraction=0.3, **kw)
    het = got.schedule_stats["hetero"]
    assert het["host_tasks"] > 0 and het["host_tasks_executed"] > 0
    assert plan.num_waves >= 1 and plan._host_lane is not None
    if name == "cc":
        np.testing.assert_array_equal(got.result, want.result)
    else:
        for k in ("parent", "dist"):
            np.testing.assert_array_equal(got.result[k], want.result[k])
        assert (got.schedule_stats["direction"]["decisions"]
                == want.schedule_stats["direction"]["decisions"])
    plan.close()


def test_real_oom_is_classified(cuda):
    from repro_torch.core.resilience import classify

    total = torch.cuda.get_device_properties(cuda).total_memory
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda)
    assert classify(err.value) == "oom"
    x = torch.ones(1 << 20, device=cuda)
    assert float(x.sum()) == float(1 << 20)


def test_streamed_faults_recover_on_the_card(cuda, small_store):
    """An OOM at a copy, a failed wave and a failed host unit, each
    recovered with both streams quiesced: labels equal the fault-free run."""
    from repro_torch.core import RetryPolicy

    kw = dict(mode="sparse_only", host_fraction=0.3)
    budget = _quarter_budget(afforest_algorithm(), small_store, mode="sparse_only")
    _, want = _streamed(afforest_algorithm(), small_store, cuda, budget, **kw)
    spec = "stage.device_put:oom:at(2);wave.compute:raise:at(1);host.task:raise:once"
    plan = compile_plan(afforest_algorithm(), small_store, device=cuda, memory_budget=budget,
                        faults=spec, retry_policy=RetryPolicy(max_retries=6), **kw)
    got = plan.run()
    np.testing.assert_array_equal(got.result, want.result)
    r = got.schedule_stats["resilience"]
    assert r["injected"] == 3 and r["retries"] >= 3 and r["oom_repacks"] >= 1
    plan.close()


def test_streamed_resume_bit_identical(cuda, small_store, tmp_path):
    src = int(np.argmax(small_store.degrees))
    budget = _quarter_budget(bfs_algorithm(src), small_store, **_PLAN_KW)
    kw = dict(_PLAN_KW, direction="auto", memory_budget=budget)
    base = compile_plan(bfs_algorithm(src), small_store, device=cuda, **kw).run()
    d = str(tmp_path / "ck")
    compile_plan(bfs_algorithm(src), small_store, device=cuda, checkpoint_every=1,
                 checkpoint_dir=d, **kw).run()
    fresh = compile_plan(bfs_algorithm(src), small_store, device=cuda, **kw)
    for step in range(1, base.iterations + 1):
        res = fresh.resume(d, step=step)
        for k in ("parent", "dist"):
            np.testing.assert_array_equal(res.result[k], base.result[k])
        assert (res.schedule_stats["direction"]["decisions"]
                == base.schedule_stats["direction"]["decisions"])


def test_graph_server_batches_on_the_card(cuda, small_store):
    """An in-core batch of 4 BFS and one of 4 PageRank queries on the
    card against their solo runs there: BFS bit for bit, PageRank within
    rtol 1e-5 (the batched and solo index_adds are atomic float adds).
    Each batch launches its tile kernel once per level or iteration."""
    srcs = [int(np.argmax(small_store.degrees)), 3, 100, 777]
    seeds = [[0], [5, 9], [17], [1, 2, 3]]
    srv = GraphServer(max_batch=4, device=cuda)
    srv.register_graph("g", small_store, direction="auto", **_PLAN_KW)
    srv.register_graph("g-pr", small_store, **_PLAN_KW)
    ub = [srv.submit(Query("g", "bfs", dict(source=s))) for s in srcs]
    up = [srv.submit(Query("g-pr", "pagerank", dict(seeds=s))) for s in seeds]
    registry.reset_launch_counts()
    assert srv.step() == 4                     # the BFS batch (FIFO head)
    pulls = srv.result(ub[0]).schedule_stats["direction"]["decisions"].count("pull")
    assert pulls > 0 and registry.launch_counts()["frontier_tiles"] == pulls
    steps = srv.stats()["steps_executed"]
    registry.reset_launch_counts()
    assert srv.step() == 4                     # the PageRank batch
    assert registry.launch_counts()["spmv_tiles"] == srv.stats()["steps_executed"] - steps
    st = srv.stats()
    assert st["batch_sizes"] == [4, 4] and st["bucket_sizes"] == [4, 4]
    for uid, s in zip(ub, srcs):
        solo = compile_plan(bfs_algorithm(s), small_store, device=cuda, direction="auto",
                            **_PLAN_KW).run().result
        for k in ("parent", "dist"):
            np.testing.assert_array_equal(srv.result(uid).result[k], solo[k])
    for uid, s in zip(up, seeds):
        solo = compile_plan(pagerank_algorithm(seeds=s), small_store, device=cuda,
                            **_PLAN_KW).run().result
        np.testing.assert_allclose(srv.result(uid).result, solo, rtol=1e-5, atol=1e-9)


# ------------------------------------------------------------------ A10
def _kernel_calls(dev, rng):
    """Each kernel's call on ``dev`` and its plain version's on the same
    inputs: name → (launch, plain)."""
    tiles = torch.from_numpy(_tiles(rng, 3, 128, 0.1)).to(dev)
    xs = torch.from_numpy(rng.random((3, 128)).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.random((3, 128)) < 0.3).to(dev)
    idx = torch.tensor([[0, 1, 2], [1, 1, 2], [2, 0, 1]], dtype=torch.int32, device=dev)
    eidx = torch.from_numpy(rng.integers(0, 500, (2, 64, 8)).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random((2, 64, 8)) < 0.7).to(dev)
    x = torch.from_numpy(rng.random((2, 500)).astype(np.float32)).to(dev)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 128, 64)).astype(np.float32))
               .to(dev, torch.bfloat16) for _ in range(3))
    return {
        "spmv_tiles": (lambda: spmv_tiles(tiles, xs), lambda: ref.spmv_tiles_ref(tiles, xs)),
        "frontier_tiles": (lambda: frontier_tiles(tiles, f),
                           lambda: ref.frontier_tiles_ref(tiles, f)),
        "tc_tiles": (lambda: tc_tiles(tiles, idx), lambda: ref.tc_tiles_idx_ref(tiles, idx)),
        "spmv_ell": (lambda: spmv_ell(eidx, valid, x), lambda: ref.spmv_ell_ref(eidx, valid, x)),
        "flash_attention": (lambda: flash_attention(q, k, v).float(),
                            lambda: ref.attention_ref(q.float(), k.float(), v.float()).float()),
    }


@pytest.mark.parametrize("name", ["spmv_tiles", "frontier_tiles", "tc_tiles", "spmv_ell",
                                  "flash_attention"])
def test_kernels_keep_the_callers_device(cuda, name):
    """A launch on one card leaves the calling thread's current device as
    it found it (a mesh drives several cards from one thread).  With one
    card only the first half runs."""
    tol = dict(rtol=2**-7, atol=2e-3) if name == "flash_attention" else dict(rtol=1e-5,
                                                                               atol=1e-6)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    pairs = [(0, 0)] + ([(0, 1), (1, 0)] if len(cards) >= 2 else [])
    for current, target in pairs:
        torch.cuda.set_device(current)
        launch, plain = _kernel_calls(cards[target], np.random.default_rng(target))[name]
        before = registry.launch_counts()[name]
        got = launch()
        assert torch.cuda.current_device() == current, (name, current, target)
        assert registry.launch_counts()[name] == before + 1
        assert got.device == cards[target]
        torch.testing.assert_close(got, plain(), **tol)
    torch.cuda.set_device(0)


def _card_mesh():
    from repro_torch.core import DeviceMesh

    n = torch.cuda.device_count()
    return DeviceMesh.cuda(n) if n >= 2 else DeviceMesh(["cuda:0"] * 2)


@pytest.mark.parametrize("name", ["pagerank", "bfs", "tc"])
def test_mesh_streamed_cuda_vs_cpu(cuda, small_store, name):
    """A mesh of the available cards (two shards on one card when there
    is one): every shard launches the path's tile kernel, and the result
    equals the CPU's in-core run (PageRank within 1e-4)."""
    mesh = _card_mesh()
    if name == "tc":
        store, alg, kernel = (build_block_store(orient_dag(rmat(11, 16, seed=5)), 8),
                              tc_algorithm(), "tc_tiles")
        kw = dict(_PLAN_KW)
    elif name == "bfs":
        store, kernel = small_store, "frontier_tiles"
        alg = bfs_algorithm(int(np.argmax(small_store.degrees)))
        kw = dict(_PLAN_KW, direction="auto")
    else:
        store, alg, kernel, kw = small_store, pagerank_algorithm(), "spmv_tiles", dict(_PLAN_KW)
    budget = _quarter_budget(alg, store, **_PLAN_KW)      # per shard
    cpu = compile_plan(alg, store, device="cpu", **kw).run()
    plan = compile_plan(alg, store, memory_budget=budget, mesh=mesh, **kw)
    registry.reset_launch_counts()
    got = plan.run()
    torch.cuda.synchronize()
    st = got.schedule_stats["streaming"]
    assert st["mesh_devices"] == mesh.size and st["collective_bytes"] > 0
    assert all(b + w <= budget for b, w in zip(st["per_device_bytes"], st["workspace_per_wave"]))
    assert registry.launch_counts()[kernel] > 0
    if name == "pagerank":
        np.testing.assert_allclose(got.result, cpu.result, rtol=1e-4, atol=1e-7)
    elif name == "bfs":
        for k in ("parent", "dist"):
            np.testing.assert_array_equal(got.result[k], cpu.result[k])
    else:
        assert got.result == cpu.result
    assert torch.cuda.current_device() == 0
