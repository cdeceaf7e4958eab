"""The port's in-core engine on the CPU against the JAX package's
``backend="reference"`` runs, on one store carried across with
``repro_torch.interop``.

Tolerances: PageRank sums float32 contributions in another order than
XLA's segment sum, so ranks agree to rtol 1e-5 / atol 1e-8 and the
iteration counts must be equal (both are reported when they are not).
BFS parents, distances and direction decisions and TC counts are
integers and must be identical.
"""
import sys

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.algorithms import bfs_algorithm as r_bfs
from repro.algorithms import pagerank_algorithm as r_pagerank
from repro.algorithms import tc_algorithm as r_tc
from repro.algorithms.tc import orient_dag as r_orient_dag

from repro_torch import interop
from repro_torch.algorithms import (
    bfs, bfs_algorithm, pagerank, pagerank_algorithm, tc_algorithm, triangle_count,
)
from repro_torch.core import batch_states, compile_plan, rmat
from repro_torch.kernels.spmv_tiles import spmv_tiles

GRAPHS = {
    "rmat": lambda: rc.degree_order(rc.rmat(9, 8, seed=3), ascending=False)[0],
    "er": lambda: rc.erdos_renyi(400, 6.0, seed=2),
    "road": lambda: rc.grid_road(16),
    "star": lambda: rc.star_skew(512, hubs=3, seed=1),
}
PLAN_KW = dict(tile_dim=128, dense_density=0.001)


def _carry(sr):
    """The port's store from the reference store's numpy fields."""
    fields = {k: getattr(sr, k) for k in interop.STORE_FIELDS if k != "cuts"}
    return interop.store_from_numpy(dict(fields, cuts=sr.layout.cuts),
                                    directed=sr.graph.directed, name=sr.graph.name)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("seeds", [None, [0, 5, 9]])
@pytest.mark.parametrize("mode", ["hybrid", "dense_only"])
def test_pagerank_matches_reference(name, seeds, mode):
    sr = rc.build_block_store(GRAPHS[name](), 4)
    want = rc.compile_plan(r_pagerank(seeds=seeds), sr, backend="reference",
                           mode=mode, **PLAN_KW).run()
    plan = compile_plan(pagerank_algorithm(seeds=seeds), _carry(sr), device="cpu",
                        mode=mode, **PLAN_KW)
    got = plan.run()
    assert plan.schedule.stats == want.schedule_stats
    assert got.iterations == want.iterations, \
        f"iterations: port {got.iterations}, reference {want.iterations}"
    np.testing.assert_allclose(got.result, want.result, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pagerank_dense_path_passes_the_store_extents(name, monkeypatch):
    # the module, not the function the package re-exports under its name
    port_pagerank = sys.modules["repro_torch.algorithms.pagerank"]
    calls = []

    def recording(tiles, xs, extents=None):
        calls.append(extents)
        return spmv_tiles(tiles, xs, extents)

    monkeypatch.setattr(port_pagerank, "spmv_tiles", recording)
    sr = rc.build_block_store(GRAPHS[name](), 4)
    want = rc.compile_plan(r_pagerank(), sr, backend="reference", **PLAN_KW).run()
    plan = compile_plan(pagerank_algorithm(), _carry(sr), device="cpu", **PLAN_KW)
    got = plan.run()
    ctx = plan.context
    assert plan.schedule.stats["dense_tasks"] > 0 and len(calls) == got.iterations
    assert all(rows is ctx.tile_rows and cols is ctx.tile_cols for rows, cols in calls)
    assert got.iterations == want.iterations, \
        f"iterations: port {got.iterations}, reference {want.iterations}"
    np.testing.assert_allclose(got.result, want.result, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pagerank_steps_from_the_same_mid_run_state(name):
    sr = rc.build_block_store(GRAPHS[name](), 4)
    mid = rc.compile_plan(r_pagerank(max_iters=3), sr, backend="reference",
                          **PLAN_KW).run().state
    want = rc.compile_plan(r_pagerank(), sr, backend="reference", **PLAN_KW).run(state=mid)
    got = compile_plan(pagerank_algorithm(), _carry(sr), device="cpu", **PLAN_KW).run(
        state=interop.state_from_numpy(mid, "cpu"))
    assert got.iterations == want.iterations, \
        f"iterations: port {got.iterations}, reference {want.iterations}"
    np.testing.assert_allclose(got.result, want.result, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("direction", [None, "push", "pull", "auto"])
def test_bfs_matches_reference_bit_for_bit(name, direction):
    sr = rc.build_block_store(GRAPHS[name](), 4)
    src = int(np.argmax(sr.degrees))
    want = rc.compile_plan(r_bfs(src), sr, backend="reference", direction=direction,
                           **PLAN_KW).run()
    got = compile_plan(bfs_algorithm(src), _carry(sr), device="cpu",
                       direction=direction, **PLAN_KW).run()
    assert got.iterations == want.iterations
    for k in ("parent", "dist"):
        np.testing.assert_array_equal(got.result[k], np.asarray(want.result[k]), err_msg=k)
    if direction is None:
        assert "direction" not in got.schedule_stats
    else:
        d_got, d_want = got.schedule_stats["direction"], want.schedule_stats["direction"]
        assert d_got["decisions"] == d_want["decisions"]
        assert d_got["switches"] == d_want["switches"]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_directions_agree(name):
    sr = rc.build_block_store(GRAPHS[name](), 4)
    store = _carry(sr)
    src = int(np.argmax(sr.degrees))
    runs = {d: compile_plan(bfs_algorithm(src), store, device="cpu", direction=d,
                            **PLAN_KW).run() for d in ("push", "pull", "auto")}
    for d in ("pull", "auto"):
        for k in ("parent", "dist"):
            np.testing.assert_array_equal(runs[d].result[k], runs["push"].result[k])


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("p,mode", [(4, "hybrid"), (4, "dense_only"), (8, "hybrid")])
def test_tc_matches_reference_exactly(name, p, mode):
    sr = rc.build_block_store(r_orient_dag(GRAPHS[name]()), p)
    want = rc.compile_plan(r_tc(), sr, backend="reference", mode=mode, **PLAN_KW).run()
    plan = compile_plan(tc_algorithm(), _carry(sr), device="cpu", mode=mode, **PLAN_KW)
    assert plan.run().result == want.result
    assert plan.schedule.stats == want.schedule_stats


def test_convenience_wrappers():
    g = rmat(8, 8, seed=3)
    from repro_torch.core import build_block_store

    store = build_block_store(g, 4)
    ranks = pagerank(store, device="cpu")
    assert abs(float(ranks.sum()) - 1.0) < 1e-3
    assert bfs(store, 0, device="cpu")["dist"][0] == 0
    assert triangle_count(g, p=4, device="cpu") == \
        r_tc().finalize(None, rc.compile_plan(
            r_tc(), rc.build_block_store(r_orient_dag(rc.rmat(8, 8, seed=3)), 4),
            backend="reference").run().state)


@pytest.fixture
def road_store():
    return _carry(rc.build_block_store(rc.grid_road(8), 2))


@pytest.mark.parametrize("budget,mesh,error,match", [
    (None, "cpu-mesh", ValueError, "memory_budget"),
    ("64KB", object(), TypeError, "DeviceMesh"),
], ids=["mesh-without-budget", "mesh-not-a-mesh"])
def test_unported_arguments_raise(road_store, budget, mesh, error, match):
    """No argument of compile_plan is left unported: ``mesh`` (ROADMAP
    A10) is checked as the reference checks it, a ``DeviceMesh`` without
    a ``memory_budget`` raising the reference's ``ValueError``, and
    anything but a ``DeviceMesh`` a ``TypeError``."""
    from repro_torch.core import DeviceMesh

    if mesh == "cpu-mesh":
        mesh = DeviceMesh(["cpu"])
        with pytest.raises(ValueError, match="memory_budget"):
            rc.compile_plan(r_pagerank(), rc.build_block_store(rc.grid_road(8), 2),
                            mesh=object())
    with pytest.raises(error, match=match):
        compile_plan(pagerank_algorithm(), road_store, device="cpu",
                     memory_budget=budget, mesh=mesh)


@pytest.mark.parametrize("budget", [None, "64KB"], ids=["incore", "streamed"])
@pytest.mark.parametrize("arg", ["host_fraction", "faults", "checkpoint_every",
                                 "checkpoint_dir", "retry_policy"])
def test_ported_arguments_run(road_store, arg, budget, tmp_path):
    """The host lane (ROADMAP A8) and the fault-tolerant runtime (A9)
    arguments build a plan that runs to the fault-free ranks."""
    from repro_torch.core import RetryPolicy

    if arg == "host_fraction" and budget is None:
        with pytest.raises(ValueError, match="memory_budget"):
            compile_plan(pagerank_algorithm(), road_store, device="cpu", host_fraction=0.5)
        return
    ckpt = str(tmp_path / "ckpt")
    kw = dict(host_fraction=dict(host_fraction=0.5),
              faults=dict(faults="wave.compute:raise"),
              checkpoint_every=dict(checkpoint_every=1, checkpoint_dir=ckpt),
              checkpoint_dir=dict(checkpoint_dir=ckpt),
              retry_policy=dict(retry_policy=RetryPolicy(max_retries=1)))[arg]
    want = compile_plan(pagerank_algorithm(), road_store, device="cpu").run()
    got = compile_plan(pagerank_algorithm(), road_store, device="cpu",
                       **(dict(memory_budget=budget) if budget else {}), **kw).run()
    np.testing.assert_allclose(got.result, want.result, rtol=1e-5, atol=1e-8)


def test_batched_states_raise(road_store):
    # a batched state runs (graph serving's query axis); what raises is
    # a malformed batch or an empty or out-of-range source list
    plan = compile_plan(pagerank_algorithm(), road_store, device="cpu")
    state = pagerank_algorithm().init_state(road_store)
    batched = {k: np.stack([v, v]) for k, v in state.items()}
    got = plan.run(state=batched)
    solo = plan.run()
    assert got.state["rank"].shape == (2, road_store.n)
    for row in got.state["rank"]:
        assert torch.equal(row, solo.state["rank"])
    with pytest.raises(ValueError, match="pad_to"):
        batch_states([state, state], pad_to=1)
    with pytest.raises(ValueError, match="at least one"):
        bfs_algorithm(0, sources=[])
    with pytest.raises(ValueError, match="out of range"):
        bfs_algorithm(0, sources=[0, road_store.n]).init_state(road_store)


def test_steps_are_built_once_per_direction(road_store):
    push = compile_plan(bfs_algorithm(0), road_store, device="cpu")
    auto = compile_plan(bfs_algorithm(0), road_store, device="cpu", direction="auto")
    again = compile_plan(bfs_algorithm(3), road_store, device="cpu", direction="auto")
    assert (push.compile_count, auto.compile_count, again.compile_count) == (1, 2, 2)
    assert again._steps["pull"] is auto._steps["pull"]
    other = _carry(rc.build_block_store(rc.grid_road(6), 2))
    assert auto.run(other).result["dist"][0] == 0 and auto.compile_count == 2


def test_state_is_moved_to_the_plan_device(road_store):
    plan = compile_plan(pagerank_algorithm(), road_store, device="cpu")
    res = plan.run()
    assert all(t.device == torch.device("cpu") for t in res.state.values())
    assert res.state["rank"].dtype == torch.float32
