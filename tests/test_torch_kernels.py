"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode) and oracles, on the shape sweeps of
tests/test_kernels.py; and the no-fallback dispatch rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.frontier_tile import frontier_tiles as p_frontier
from repro.kernels.spmv_tile import spmv_tiles as p_spmv
from repro.kernels.tc_tile import tc_tiles as p_tc

from repro_torch.kernels import ref, registry
from repro_torch.kernels.frontier_tiles import frontier_tiles
from repro_torch.kernels.spmv_tiles import spmv_tiles
from repro_torch.kernels.tc_tiles import tc_tiles

INT_MAX = 2**31 - 1
DTYPES = {"f32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tiles(rng, nb, t, density):
    return (rng.random((nb, t, t)) < density).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (0/1 tiles and values rounded to bf16 convert exactly)."""
    j = jnp.asarray(a).astype(DTYPES[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype][1])


@pytest.mark.parametrize("nb,t,block_t", [(1, 128, 128), (3, 128, 128), (2, 256, 128),
                                          (1, 512, 128), (2, 256, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tc_tiles_plain_vs_pallas(nb, t, block_t, dtype):
    rng = np.random.default_rng(nb * 1000 + t)
    ja, ta = _both(_tiles(rng, 3 * nb, t, 0.05), dtype)
    a_ik, a_jk, a_ij = ja[:nb], ja[nb:2 * nb], ja[2 * nb:]
    want = float(p_tc(a_ik, a_jk, a_ij, block_t=block_t, interpret=True))
    # the triple (ij, ik, jk) reads the three tiles in place
    b = np.arange(nb)
    idx = torch.from_numpy(np.stack([2 * nb + b, b, nb + b], 1).astype(np.int32))
    got = tc_tiles(ta, idx)
    assert got.dtype == torch.int64 and int(got) == want        # exact below 2**24
    np.testing.assert_allclose(
        float(ref.tc_tiles_ref(ta[:nb], ta[nb:2 * nb], ta[2 * nb:])), want, rtol=1e-5)


def test_tc_tiles_plain_masks_padding_triples():
    rng = np.random.default_rng(7)
    _, ta = _both(_tiles(rng, 4, 64, 0.2), "f32")
    idx = torch.tensor([[0, 1, 2], [-1, -1, -1], [3, 3, 3]], dtype=torch.int32)
    want = int(tc_tiles(ta, idx[[0, 2]]))
    assert want > 0 and int(tc_tiles(ta, idx)) == want


def _ragged(rng, nd, t, density):
    """0/1 tiles zeroed outside random extents drawn from (0, 1, 63, 65, T),
    and those extents as int32 tensors."""
    tiles = _tiles(rng, nd, t, density)
    rows, cols = (rng.choice([0, 1, 63, 65, t], nd).astype(np.int32) for _ in "rc")
    for n in range(nd):
        tiles[n, rows[n]:] = 0
        tiles[n, :, cols[n]:] = 0
    return tiles, (torch.from_numpy(rows), torch.from_numpy(cols))


@pytest.mark.parametrize("nd,nb,t", [(5, 7, 128), (4, 3, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tc_tiles_plain_with_extents_vs_pallas(nd, nb, t, dtype):
    rng = np.random.default_rng(nd * 100 + t)
    tiles, extents = _ragged(rng, nd, t, 0.2)
    idx = rng.integers(0, nd, (nb, 3)).astype(np.int32)
    ja, ta = _both(tiles, dtype)
    want = float(p_tc(ja[idx[:, 1]], ja[idx[:, 2]], ja[idx[:, 0]], block_t=128,
                      interpret=True))
    got = tc_tiles(ta, torch.from_numpy(idx), extents)
    assert got.dtype == torch.int64 and int(got) == want       # exact below 2**24


@pytest.mark.parametrize("nd,t", [(6, 128), (3, 192)])
@pytest.mark.parametrize("fdtype", [torch.float32, torch.bool])
def test_frontier_tiles_plain_with_extents_vs_pallas(nd, t, fdtype):
    rng = np.random.default_rng(nd * 100 + t)
    tiles, extents = _ragged(rng, nd, t, 0.05)
    f = (rng.random((nd, t)) < 0.3).astype(np.float32)
    want = np.asarray(p_frontier(jnp.asarray(tiles), jnp.asarray(f), interpret=True))
    got = frontier_tiles(torch.from_numpy(tiles), torch.from_numpy(f).to(fdtype), extents)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _bad_extents(nd):
    rows = torch.full((nd,), 8, dtype=torch.int32)
    return [rows,                                               # not a pair
            (rows, rows[:-1]),                                  # cols of the wrong length
            (rows.long(), rows),                                # rows not int32
            (rows[:, None], rows),                              # rows not 1-D
            (rows, None)]                                       # cols missing


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("name", ["tc_tiles", "frontier_tiles", "spmv_tiles"])
def test_tile_kernels_reject_wrong_shaped_extents(name, case):
    tiles, second = _cpu_args(name)
    with pytest.raises(ValueError, match="extents"):
        registry.get_kernel(name)(tiles, second, _bad_extents(tiles.shape[0])[case])


@pytest.mark.parametrize("nb,t", [(1, 128), (4, 128), (2, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_spmv_tiles_plain_vs_pallas(nb, t, dtype):
    rng = np.random.default_rng(nb * 1000 + t)
    jt, tt = _both(_tiles(rng, nb, t, 0.1), dtype)
    jx, tx = _both(rng.random((nb, t)).astype(np.float32), dtype)
    want = np.float32(p_spmv(jt, jx, interpret=True))
    got = spmv_tiles(tt, tx)
    assert got.dtype == torch.float32
    # both sum the same float32 products in a different order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("nd,t", [(6, 128), (5, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_spmv_tiles_plain_with_extents_vs_pallas(nd, t, dtype):
    rng = np.random.default_rng(nd * 100 + t)
    tiles, (rows, cols) = _ragged(rng, nd, t, 0.1)
    rows[:2], cols[:2] = torch.tensor([0, t]), torch.tensor([t, 0])   # 0 x T and T x 0
    tiles[0], tiles[1] = 0, 0
    jt, tt = _both(tiles, dtype)
    jx, tx = _both(rng.random((nd, t)).astype(np.float32), dtype)
    want = np.float32(p_spmv(jt, jx, interpret=True))
    got = spmv_tiles(tt, tx, (rows, cols))
    assert got.dtype == torch.float32
    # the same float32 products summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    past = torch.arange(t)[None, :] >= cols[:, None]
    assert bool((got[past] == 0).all())         # columns past the rectangle are 0


FRONTIER_CASES = [(1, 128, 128), (4, 128, 128), (2, 256, 128), (1, 512, 128),
                  # tile dims that are not a power of two
                  (2, 192, 128), (1, 96, 64), (2, 160, 128), (1, 48, 128)]


@pytest.mark.parametrize("nb,t,block_t", FRONTIER_CASES)
@pytest.mark.parametrize("fdtype", [torch.float32, torch.bool])
def test_frontier_tiles_plain_vs_pallas(nb, t, block_t, fdtype):
    rng = np.random.default_rng(nb * 1000 + t)
    tiles = _tiles(rng, nb, t, 0.05)
    f = (rng.random((nb, t)) < 0.3).astype(np.float32)
    want = np.asarray(p_frontier(jnp.asarray(tiles), jnp.asarray(f), block_t=block_t,
                                 interpret=True))
    got = frontier_tiles(torch.from_numpy(tiles), torch.from_numpy(f).to(fdtype))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_frontier_tiles_plain_empty_frontier():
    tiles = torch.from_numpy(_tiles(np.random.default_rng(0), 2, 128, 0.05))
    got = frontier_tiles(tiles, torch.zeros((2, 128)))
    assert bool((got == INT_MAX).all())


@pytest.mark.parametrize("b,r,k,n", [(1, 128, 8, 256), (3, 256, 16, 512)])
def test_spmv_ell_plain_vs_oracle(b, r, k, n):
    rng = np.random.default_rng(b + r)
    idx = rng.integers(0, n, (b, r, k)).astype(np.int32)
    valid = rng.random((b, r, k)) < 0.7
    x = rng.random((b, n)).astype(np.float32)
    want = np.asarray(jref.spmv_ell_ref(jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(x)))
    got = ref.spmv_ell_ref(torch.from_numpy(idx), torch.from_numpy(valid), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("b,r,k,n", [(1, 128, 8, 256), (3, 256, 16, 512)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_spmv_ell_plain_vs_pallas(b, r, k, n, dtype):
    from repro.kernels.spmv_ell import spmv_ell as p_spmv_ell
    from repro_torch.kernels.spmv_ell import spmv_ell

    rng = np.random.default_rng(b * 100 + k)
    idx = rng.integers(0, n, (b, r, k)).astype(np.int32)
    valid = rng.random((b, r, k)) < 0.7
    jx, tx = _both(rng.random((b, n)).astype(np.float32), dtype)
    want = p_spmv_ell(jnp.asarray(idx), jnp.asarray(valid), jx, interpret=True)
    got = spmv_ell(torch.from_numpy(idx), torch.from_numpy(valid), tx)
    assert got.dtype == tx.dtype and got.shape == (b, r)
    # f32: the same sums in another order; bf16: both round a sum of up
    # to 16 values near 0.5 to bf16 (2^-8 relative)
    tol = dict(rtol=1e-5) if dtype == "f32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.float32(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [(1, 2, 128, 128, 64, True),
                                                (2, 1, 128, 256, 64, True),
                                                (1, 1, 256, 128, 64, False)])
def test_attention_plain_vs_oracle(b, h, sq, sk, d, causal):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal))
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def _cpu_args(name):
    if name == "spmv_ell":
        return (torch.zeros((1, 2, 3), dtype=torch.int32), torch.ones((1, 2, 3), dtype=torch.bool),
                torch.arange(4.0)[None])
    if name == "flash_attention":
        return torch.ones((1, 2, 4, 64)), torch.ones((1, 1, 4, 64)), torch.ones((1, 1, 4, 64))
    if name == "flash_attention_bwd":
        q, k = torch.ones((1, 2, 4, 64)), torch.ones((1, 1, 4, 64))
        return q, k, k, q, torch.zeros((1, 2, 4)), q
    tiles = torch.zeros((2, 8, 8))
    second = {"spmv_tiles": torch.zeros((2, 8)), "frontier_tiles": torch.zeros((2, 8)),
              "tc_tiles": torch.zeros((1, 3), dtype=torch.int32)}[name]
    return tiles, second


@pytest.mark.parametrize("name", sorted(registry.KERNELS))
def test_cuda_backend_on_cpu_tensors_raises(name):
    before = registry.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        registry.get_kernel(name, "cuda")(*_cpu_args(name))
    assert registry.launch_counts() == before


@pytest.mark.parametrize("name", sorted(registry.KERNELS))
def test_cpu_tensors_take_the_plain_version(name):
    before = registry.launch_counts()
    got = registry.get_kernel(name)(*_cpu_args(name))
    want = registry.get_kernel(name, "plain")(*_cpu_args(name))
    if isinstance(got, tuple):      # a backward: (dq, dk, dv)
        assert len(got) == len(want) and all(map(torch.equal, got, want))
    else:
        assert torch.equal(got, want)
    assert registry.launch_counts() == before


def test_get_kernel_rejects_unknown_names():
    with pytest.raises(KeyError):
        registry.get_kernel("spmv_csr")
    with pytest.raises(ValueError, match="backend"):
        registry.get_kernel("spmv_tiles", "triton")
