"""The port's CUDA kernels and algorithms on a card, against the port's
plain versions and its CPU runs.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when
no card is present.  This file imports no jax, so it runs where only
PyTorch is installed::

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports the JAX package.)
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import bfs_algorithm, pagerank_algorithm, tc_algorithm
from repro_torch.algorithms.tc import orient_dag
from repro_torch.core import build_block_store, compile_plan, degree_order, rmat
from repro_torch.kernels import ref, registry
from repro_torch.kernels.frontier_tiles import frontier_tiles
from repro_torch.kernels.spmv_tiles import spmv_tiles
from repro_torch.kernels.tc_tiles import tc_tiles

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
