"""Graph serving in the port on the CPU, against the JAX package.

The same stores (the reference's arrays carried into the port), the
same queries and the same script of submissions, steps, cancels and
faults go through ``repro.serve.GraphServer`` (on its ``xla`` backend)
and ``repro_torch.serve.GraphServer(device="cpu")`` in one interpreter.

What must be equal: every query's uid, status, reason, priced bytes and
retry hint; the admission controller's resident, in-flight and
high-water bytes; ``stats()`` with every key and value except the
latency percentiles (wall clock).  Results: BFS, k-core and CC bit for
bit; PageRank within rtol 1e-5 / atol 1e-7 of the reference (float32
sums in another order).  Inside the port, a batched row equals its solo
run bit for bit on the CPU: every per-row operation (the flattened
``index_add``, the per-row sums of ``post``, the plain tile kernels)
keeps the solo run's order.

Resident bytes are equal on every kind of plan: the admission price of
an in-core context leaves out the port's tile extents, which the
reference's contexts do not hold (``test_resident_bytes``).
"""
import functools
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.algorithms as ra
import repro.core as rc
import repro.serve as rs
from repro.core.membudget import batch_state_bytes as r_batch_state_bytes
from repro.core.membudget import tree_array_bytes as r_tree_array_bytes

import repro_torch.algorithms as pa
import repro_torch.serve as ps
from repro_torch.core import (
    batch_state_bytes, batch_states, compile_plan, tree_array_bytes, unbatch_state,
)
from repro_torch.core.engine import context_bytes

from test_torch_algorithms import _carry

SPARSE = dict(mode="sparse_only")
HYBRID = dict(mode="hybrid", dense_density=0.001, tile_dim=128)
PR_TOL = dict(rtol=1e-5, atol=1e-7)


def _permuted(g, seed):
    """Same n and m, other labels: a different graph of the same shape."""
    perm = np.random.default_rng(seed).permutation(g.n)
    s, d = g.coo()
    return rc.from_edges(perm[s], perm[d], n=g.n)


def _pair(graph):
    sr = rc.build_block_store(graph, 4)
    return sr, _carry(sr)


@pytest.fixture(scope="module")
def stores():
    """name → (reference store, port store) on the same arrays.  A store
    keeps the tiles its first tiled plan materializes, and later contexts
    over it carry them, so the server scenarios (``serve``, ``perm``,
    ``chaos`` sparse-only; ``stream`` streamed; ``hybrid`` in-core with
    dense tiles) have stores of their own."""
    g = rc.rmat(8, 8, seed=3)
    return {"web": _pair(g), "serve": _pair(g), "stream": _pair(g), "hybrid": _pair(g),
            "perm": _pair(_permuted(g, 7)), "chaos": _pair(rc.rmat(8, 8, seed=5))}


def _packages(stores):
    """The two packages behind one interface: the reference on its xla
    backend, the port on the CPU."""
    ref = SimpleNamespace(
        Server=rs.GraphServer, Query=rs.Query, pagerank=ra.pagerank_algorithm,
        compile_plan=functools.partial(rc.compile_plan, backend="xla"),
        state_bytes=lambda s: r_batch_state_bytes(r_tree_array_bytes(s), 1),
        stores={k: v[0] for k, v in stores.items()})
    port = SimpleNamespace(
        Server=functools.partial(ps.GraphServer, device="cpu"), Query=ps.Query,
        pagerank=pa.pagerank_algorithm,
        compile_plan=functools.partial(compile_plan, device="cpu"),
        state_bytes=lambda s: batch_state_bytes(tree_array_bytes(s), 1),
        stores={k: v[1] for k, v in stores.items()})
    return ref, port


def _transcript(srv, uids) -> dict:
    """Everything the two servers must agree on, latency excluded."""
    queries = []
    for u in uids:
        q = srv.result(u)
        queries.append(None if q is None else dict(
            uid=q.uid, status=q.status, reason=q.reason, priced=q.priced_bytes,
            retry_after=q.retry_after_s, graph=q.graph, algorithm=q.algorithm))
    stats = srv.stats()
    stats.pop("latency_s")
    adm = srv.admission
    return dict(queries=queries, stats=stats, resident=adm.resident_bytes,
                in_flight=adm.in_flight_bytes, reserved=adm.reserved_bytes,
                high_water=adm.high_water_bytes)


def _results(srv, uids) -> list:
    return [srv.result(u).result if srv.result(u) is not None else None for u in uids]


# ------------------------------------------------------------- scenarios
# Each takes one package's namespace and returns (transcript, results,
# extra facts); the test runs it on both packages and compares.

def _mixed(P):
    srv = P.Server(max_batch=4)
    srv.register_graph("web", P.stores["serve"], **SPARSE)
    uids = [srv.submit(P.Query("web", "pagerank", dict(seeds=[1]))),
            srv.submit(P.Query("web", "kcore", dict(k=3))),
            srv.submit(P.Query("web", "cc")),
            srv.submit(P.Query("web", "bfs", dict(source=5))),
            srv.submit(P.Query("web", "pagerank", dict(seeds=[2, 9]))),
            srv.submit(P.Query("web", "bfs", dict(source=17)))]
    srv.drain()
    return _transcript(srv, uids), _results(srv, uids), {}


def _hybrid(P):
    """In-core with dense tiles, where the batched ``spmv_tiles`` and
    ``frontier_tiles`` run through the server: a serving budget of the
    resident plans and three PageRank states, so that queries queue at
    its edge; BFS on a second name over the same store with
    ``direction="auto"`` (pull levels probe the tiles)."""
    store = P.stores["hybrid"]
    kinds = (("web", "pagerank", dict(seeds=[1])), ("web-bfs", "bfs", dict(source=0)),
             ("web", "kcore", dict(k=3)), ("web", "cc", {}))
    probe = P.Server()
    probe.register_graph("web", store, **HYBRID)
    probe.register_graph("web-bfs", store, direction="auto", **HYBRID)
    for name, kind, params in kinds:
        probe.plan_for(name, kind, params)
    per_q = P.state_bytes(P.pagerank(seeds=[0]).init_state(store))
    budget = probe.admission.resident_bytes + 3 * per_q
    srv = P.Server(memory_budget=budget, max_batch=4)
    srv.register_graph("web", store, **HYBRID)
    srv.register_graph("web-bfs", store, direction="auto", **HYBRID)
    # every plan resident before the first query: a plan charged later
    # would stand on top of the bytes already in flight (both packages)
    for name, kind, params in kinds:
        srv.plan_for(name, kind, params)
    uids = [srv.submit(P.Query("web", "pagerank", dict(seeds=s))) for s in ([1], [2, 9], [5])]
    uids += [srv.submit(P.Query("web-bfs", "bfs", dict(source=v))) for v in (0, 17, 100)]
    uids += [srv.submit(P.Query("web", "kcore", dict(k=3))), srv.submit(P.Query("web", "cc"))]
    at_submit = dict(srv.stats())
    srv.drain()
    return _transcript(srv, uids), _results(srv, uids), dict(
        budget=budget, queued=at_submit["queued"], admitted=at_submit["admitted"],
        has_tiles=srv.plan_for("web", "pagerank", dict(seeds=[1])).context.tiles is not None)


def _bucket_ladder(P):
    srv = P.Server(max_batch=8)
    srv.register_graph("web", P.stores["serve"], **SPARSE)
    params = dict(damping=0.66)
    uids = [srv.submit(P.Query("web", "pagerank", dict(params, seeds=s))) for s in ([2], [5], [9])]
    srv.drain()                       # 3 queries → bucket 4
    plan = srv.plan_for("web", "pagerank", dict(params, seeds=[2]))
    before = plan.compile_count
    uids += [srv.submit(P.Query("web", "pagerank", dict(params, seeds=s)))
             for s in ([11], [13], [17], [21])]
    srv.drain()                       # 4 queries → the same bucket
    return _transcript(srv, uids), _results(srv, uids), dict(
        same_steps=plan.compile_count == before)


#: streamed plans whose float sums are compared bit for bit keep their
#: waves and stay on the device: a rebalance re-packs the waves, and the
#: "auto" host lane peels tasks, from measured (wall-clock) wave times,
#: and either folds the partials in another grouping
FIXED_WAVES = dict(memory_budget="40KB", rebalance_threshold=None, host_fraction=None)


def _streamed_budget(P):
    store = P.stores["stream"]
    probe = P.compile_plan(P.pagerank(), store, **FIXED_WAVES)
    per_q = P.state_bytes(P.pagerank(seeds=[0]).init_state(store))
    budget = probe.resident_device_bytes + 3 * per_q
    srv = P.Server(memory_budget=budget, max_batch=8)
    srv.register_graph("web", store, **FIXED_WAVES)
    uids = [srv.submit(P.Query("web", "pagerank", dict(seeds=[s]))) for s in range(8)]
    depth = srv.stats()["queue_depth"]
    srv.drain()
    solo = [probe.run(state=P.pagerank(seeds=[s]).init_state(store)).result for s in range(8)]
    return _transcript(srv, uids), _results(srv, uids), dict(
        waves=probe.num_waves, budget=budget, depth_at_submit=depth, solo=solo)


def _never_fits(P):
    store = P.stores["stream"]
    probe = P.compile_plan(P.pagerank(), store, memory_budget="40KB")
    per_q = P.state_bytes(P.pagerank(seeds=[0]).init_state(store))
    srv = P.Server(memory_budget=probe.resident_device_bytes + per_q // 2)
    srv.register_graph("web", store, memory_budget="40KB")
    uids = [srv.submit(P.Query("web", "pagerank", dict(seeds=[1])))]
    srv.drain()
    return _transcript(srv, uids), [None], {}


def _tenant_cap(P):
    store = P.stores["serve"]
    per_q = P.state_bytes(P.pagerank(seeds=[0]).init_state(store))
    srv = P.Server(max_batch=1, tenant_budgets={"a": per_q, "c": per_q // 2})
    srv.register_graph("web", store, **SPARSE)
    uids = [srv.submit(P.Query("web", "pagerank", dict(seeds=[1]), tenant="a")),
            srv.submit(P.Query("web", "pagerank", dict(seeds=[2]), tenant="a")),
            srv.submit(P.Query("web", "pagerank", dict(seeds=[3]), tenant="b")),
            srv.submit(P.Query("web", "pagerank", dict(seeds=[4]), tenant="c"))]
    at_submit = dict(srv.stats())
    srv.drain()
    return _transcript(srv, uids), _results(srv, uids), dict(
        queued=at_submit["queued"], admitted=at_submit["admitted"])


def _same_shape(P):
    srv = P.Server(max_batch=4)
    srv.register_graph("a", P.stores["serve"], **SPARSE)
    srv.register_graph("b", P.stores["perm"], **SPARSE)
    params = dict(seeds=[1], damping=0.71)
    uids = [srv.submit(P.Query("a", "pagerank", params))]
    srv.drain()
    plan = srv.plan_for("a", "pagerank", params)
    before = plan.compile_count
    uids.append(srv.submit(P.Query("b", "pagerank", params)))
    srv.drain()
    fresh = P.compile_plan(P.pagerank(seeds=[1], damping=0.71), P.stores["perm"], share=False,
                           **SPARSE).run().result
    return _transcript(srv, uids), _results(srv, uids), dict(
        shared=srv.plan_for("b", "pagerank", params) is plan,
        same_steps=plan.compile_count == before, fresh=fresh)


def _unknown_inputs(P):
    srv = P.Server()
    srv.register_graph("web", P.stores["serve"], **SPARSE)
    raised = []
    for query in (P.Query("nope", "pagerank"), P.Query("web", "pagerankk"),
                  P.Query("web", "bfs", dict(sauce=3)), P.Query("web", "kcore"),
                  P.Query("web", "cc", dict(k=2))):
        try:
            srv.submit(query)
            raised.append(None)
        except Exception as e:     # the exception types are what is compared
            raised.append(type(e).__name__)
    try:
        srv.register_graph("web", P.stores["serve"])
        raised.append(None)
    except Exception as e:
        raised.append(type(e).__name__)
    return _transcript(srv, []), [], dict(raised=raised)


def _cohort_failure(P):
    srv = P.Server(faults="serve.query:raise:once")
    srv.register_graph("web", P.stores["chaos"], **SPARSE)
    uids = [srv.submit(P.Query("web", "pagerank", dict(seeds=[i]))) for i in range(3)]
    srv.drain()
    return _transcript(srv, uids), _results(srv, uids), {}


def _singleton_failure(P):
    srv = P.Server(faults="serve.query:raise:once")
    srv.register_graph("web", P.stores["chaos"], **SPARSE)
    uids = [srv.submit(P.Query("web", "pagerank"))]
    srv.drain()
    return _transcript(srv, uids), [None], {}


def _deadline_cancel(P):
    srv = P.Server()
    srv.register_graph("web", P.stores["chaos"], **SPARSE)
    uids = [srv.submit(P.Query("web", "pagerank", deadline_s=0.0)),
            srv.submit(P.Query("web", "pagerank", dict(seeds=[3]))),
            srv.submit(P.Query("web", "bfs", dict(source=4))),
            srv.submit(P.Query("web", "pagerank", dict(seeds=[5])))]
    time.sleep(0.01)
    cancelled = [srv.cancel(uids[2]), srv.cancel(uids[2]), srv.cancel(10_000)]
    srv.drain()
    return _transcript(srv, uids), _results(srv, uids), dict(cancelled=cancelled)


def _queue_full(P):
    store = P.stores["chaos"]
    probe = P.Server()
    probe.register_graph("web", store, **SPARSE)
    plan = probe.plan_for("web", "pagerank")
    priced = P.state_bytes(P.pagerank().init_state(store))
    budget = plan.resident_device_bytes + priced + priced // 2
    srv = P.Server(memory_budget=budget, max_queue=1)
    srv.register_graph("web", store, **SPARSE)
    uids = [srv.submit(P.Query("web", "pagerank")) for _ in range(3)]
    at_submit = _transcript(srv, uids)
    srv.drain()
    return _transcript(srv, uids), _results(srv, uids), dict(at_submit=at_submit)


SCENARIOS = {
    "mixed": _mixed, "bucket_ladder": _bucket_ladder, "streamed_budget": _streamed_budget,
    "never_fits": _never_fits, "tenant_cap": _tenant_cap, "same_shape": _same_shape,
    "unknown_inputs": _unknown_inputs, "cohort_failure": _cohort_failure,
    "singleton_failure": _singleton_failure, "deadline_cancel": _deadline_cancel,
    "queue_full": _queue_full, "hybrid": _hybrid,
}


def _assert_results_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        elif np.asarray(a).dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **PR_TOL)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_server_matches_reference(stores, name):
    ref, port = _packages(stores)
    want, want_res, want_extra = SCENARIOS[name](ref)
    got, got_res, got_extra = SCENARIOS[name](port)
    assert got == want
    _assert_results_match(got_res, want_res)
    # the extra facts: equal where both packages state them, else checked below
    for key in ("same_steps", "shared", "raised", "cancelled", "waves", "depth_at_submit",
                "queued", "admitted", "at_submit"):
        if key in want_extra:
            assert got_extra[key] == want_extra[key], key
    if name == "streamed_budget":
        # the invariant the reference's own test states: the high water
        # stays at or below the budget while every query completes, and
        # each row equals its solo streamed run (bit for bit in the port;
        # the reference's vmapped rows differ from its solo runs in the
        # last bits, ROADMAP C)
        st = got["stats"]
        assert got_extra["waves"] >= 4 and got_extra["depth_at_submit"] > 0
        assert st["footprint_high_water_bytes"] <= got_extra["budget"]
        assert st["rejected"] == 0 and st["completed"] == 8 and st["queued"] > 0
        for row, solo in zip(got_res, got_extra["solo"]):
            np.testing.assert_array_equal(row, solo)
        _assert_results_match(got_extra["solo"], want_extra["solo"])
    if name == "bucket_ladder":
        assert got["stats"]["bucket_sizes"] == [4, 4]
        assert got["stats"]["batch_sizes"] == [3, 4] and got_extra["same_steps"]
    if name == "same_shape":
        assert got_extra["shared"] and got_extra["same_steps"]
        np.testing.assert_allclose(got_res[1], got_extra["fresh"], atol=1e-7)
    if name == "tenant_cap":
        assert (got_extra["queued"], got_extra["admitted"]) == (1, 2)
        assert [q["status"] for q in got["queries"]] == ["done", "done", "done", "rejected"]
    if name == "never_fits":
        assert got["queries"][0]["status"] == "rejected" and got["stats"]["rejected"] == 1
    if name == "unknown_inputs":
        assert got_extra["raised"] == ["KeyError", "ValueError", "ValueError", "KeyError",
                                       "ValueError", "ValueError"]
    if name == "cohort_failure":
        assert [q["status"] for q in got["queries"]] == ["done"] * 3
        assert got["stats"]["batch_failures"] == 1
    if name == "singleton_failure":
        assert got["queries"][0]["status"] == "failed"
        assert "InjectedFault" in got["queries"][0]["reason"]
    if name == "deadline_cancel":
        assert [q["status"] for q in got["queries"]] == ["expired", "done", "cancelled", "done"]
        assert got_extra["cancelled"] == [True, False, False]
    if name == "hybrid":
        st = got["stats"]
        assert got_extra["has_tiles"] and got_extra["queued"] > 0
        assert st["footprint_high_water_bytes"] <= got_extra["budget"]
        assert [q["status"] for q in got["queries"]] == ["done"] * 8
    if name == "queue_full":
        shed = got_extra["at_submit"]["queries"][2]
        assert shed["status"] == "rejected" and "queue full" in shed["reason"]
        assert shed["retry_after"] > 0
        assert [q["status"] for q in got["queries"]] == ["done", "done", "rejected"]


def test_cohort_failure_results_match_fault_free(stores):
    # the failed cohort's members re-run solo; on the CPU a solo run and
    # its row of the fault-free batch agree bit for bit
    _, port = _packages(stores)
    _, got, _ = _cohort_failure(port)
    srv = port.Server()
    srv.register_graph("web", port.stores["chaos"], **SPARSE)
    uids = [srv.submit(port.Query("web", "pagerank", dict(seeds=[i]))) for i in range(3)]
    srv.drain()
    for row, want in zip(got, _results(srv, uids)):
        np.testing.assert_array_equal(row, want)


# ------------------------------------------------------ batched states
def test_batch_state_helpers_round_trip():
    states = [dict(x=np.full((3,), i, np.int32), s=np.int32(i)) for i in range(3)]
    b = batch_states(states, pad_to=4)
    want = rc.batch_states(states, pad_to=4)
    for k in ("x", "s"):
        assert tuple(b[k].shape) == tuple(want[k].shape)
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(want[k]))
    for i in range(4):
        row, rrow = unbatch_state(b, i), rc.unbatch_state(want, i)
        np.testing.assert_array_equal(row["x"].numpy(), np.asarray(rrow["x"]))
        assert int(row["s"]) == int(rrow["s"]) == min(i, 2)   # pad repeats the last
    with pytest.raises(ValueError):
        batch_states([])
    with pytest.raises(ValueError):
        batch_states(states, pad_to=2)


@pytest.mark.parametrize("direction", [None, "push", "pull", "auto"])
@pytest.mark.parametrize("kw", [HYBRID, SPARSE], ids=["hybrid", "sparse"])
def test_multi_source_bfs_matches_reference_and_solo(stores, direction, kw):
    sr, sp = stores["web"]
    srcs = [0, 5, 17, 100, 63]
    want = rc.compile_plan(ra.bfs_algorithm(sources=srcs), sr, backend="xla",
                           direction=direction, **kw).run()
    got = compile_plan(pa.bfs_algorithm(sources=srcs), sp, device="cpu",
                       direction=direction, **kw).run()
    assert got.iterations == want.iterations
    if direction is not None:
        assert (got.schedule_stats["direction"]["decisions"]
                == want.schedule_stats["direction"]["decisions"])
    for k in ("parent", "dist"):
        assert got.result[k].shape == (len(srcs), sp.n)
        np.testing.assert_array_equal(got.result[k], np.asarray(want.result[k]))
    for i, s in enumerate(srcs):
        solo = compile_plan(pa.bfs_algorithm(s), sp, device="cpu", direction=direction,
                            **kw).run().result
        for k in ("parent", "dist"):
            np.testing.assert_array_equal(got.result[k][i], solo[k])


@pytest.mark.parametrize("host_fraction", [None, 0.3], ids=["device", "host-lane"])
@pytest.mark.parametrize("kw", [HYBRID, SPARSE], ids=["hybrid", "sparse"])
def test_multi_source_bfs_streamed_matches_reference_and_solo(stores, kw, host_fraction):
    # with the host lane, the batched state's copies and min-folded
    # partials cross between the CPU units and the device waves
    sr, sp = stores["web"]
    srcs = [3, 11, 42]
    want = rc.compile_plan(ra.bfs_algorithm(sources=srcs), sr, backend="xla",
                           memory_budget="40KB", **kw).run()
    plan = compile_plan(pa.bfs_algorithm(sources=srcs), sp, device="cpu",
                        memory_budget="40KB", host_fraction=host_fraction, **kw)
    assert plan.num_waves >= 2
    got = plan.run()
    plan.close()                       # joins the staging worker and the host pool
    if host_fraction:
        assert got.schedule_stats["hetero"]["host_tasks_executed"] > 0
    for k in ("parent", "dist"):
        np.testing.assert_array_equal(got.result[k], np.asarray(want.result[k]))
    for i, s in enumerate(srcs):
        solo = compile_plan(pa.bfs_algorithm(s), sp, device="cpu", **kw).run().result
        for k in ("parent", "dist"):
            np.testing.assert_array_equal(got.result[k][i], solo[k])


@pytest.mark.parametrize("kw", [HYBRID, SPARSE], ids=["hybrid", "sparse"])
@pytest.mark.parametrize("budget", [None, "40KB"], ids=["in-core", "streamed"])
def test_batched_pagerank_freezes_to_solo_state(stores, kw, budget):
    """Each row of a batched run ends with its solo run's state, bit for
    bit on the CPU, although the queries converge at different
    iterations; and within float tolerance of the reference's rows."""
    sr, sp = stores["web"]
    seedsets = [[0], [7, 19], [3, 9, 27]]
    extra = {} if budget is None else dict(FIXED_WAVES, memory_budget=budget)
    plan = compile_plan(pa.pagerank_algorithm(), sp, device="cpu", **kw, **extra)
    res = plan.run(state=batch_states([pa.pagerank_algorithm(seeds=s).init_state(sp)
                                       for s in seedsets], pad_to=4))
    rplan = rc.compile_plan(ra.pagerank_algorithm(), sr, backend="xla", **kw, **extra)
    rres = rplan.run(state=rc.batch_states([ra.pagerank_algorithm(seeds=s).init_state(sr)
                                            for s in seedsets], pad_to=4))
    assert res.iterations == rres.iterations
    iters = set()
    for i, s in enumerate(seedsets):
        solo = compile_plan(pa.pagerank_algorithm(seeds=s), sp, device="cpu", **kw,
                            **extra).run()
        iters.add(solo.iterations)
        row = unbatch_state(res.state, i)
        np.testing.assert_array_equal(row["rank"].numpy(), solo.result)
        assert float(row["delta"]) == float(solo.state["delta"])
        np.testing.assert_allclose(row["rank"].numpy(),
                                   np.asarray(rc.unbatch_state(rres.state, i)["rank"]), **PR_TOL)
    assert len(iters) > 1, "the seed sets should converge at different iterations"


def test_batched_pagerank_runs_one_dense_launch_per_iteration(stores, monkeypatch):
    import sys

    port_pagerank = sys.modules["repro_torch.algorithms.pagerank"]
    shapes = []
    real = port_pagerank.spmv_tiles

    def recording(tiles, xs, extents=None):
        shapes.append(tuple(xs.shape))
        return real(tiles, xs, extents)

    monkeypatch.setattr(port_pagerank, "spmv_tiles", recording)
    _, sp = stores["web"]
    plan = compile_plan(pa.pagerank_algorithm(), sp, device="cpu", **HYBRID)
    states = [pa.pagerank_algorithm(seeds=[s]).init_state(sp) for s in (1, 2, 3)]
    res = plan.run(state=batch_states(states))
    nd = plan.context.tiles.shape[0]
    assert shapes == [(3, nd, 128)] * res.iterations


def test_personalized_pagerank_matches_reference(stores):
    sr, sp = stores["web"]
    seeds = [3, 9, 27]
    want = ra.pagerank(sr, seeds=seeds, tol=1e-9, max_iters=200, backend="xla", **HYBRID)
    got = pa.pagerank(sp, seeds=seeds, tol=1e-9, max_iters=200, device="cpu", **HYBRID)
    np.testing.assert_allclose(got, np.asarray(want), **PR_TOL)
    assert abs(got.sum() - 1.0) < 1e-3


def test_batched_bfs_checkpoint_resumes(stores, tmp_path):
    _, sp = stores["web"]
    srcs = [0, 5, 17]
    kw = dict(HYBRID, direction="auto", memory_budget="40KB")
    base = compile_plan(pa.bfs_algorithm(sources=srcs), sp, device="cpu", **kw).run()
    d = str(tmp_path / "ck")
    compile_plan(pa.bfs_algorithm(sources=srcs), sp, device="cpu", checkpoint_every=1,
                 checkpoint_dir=d, **kw).run()
    fresh = compile_plan(pa.bfs_algorithm(sources=srcs), sp, device="cpu", **kw)
    res = fresh.resume(d, step=2)
    for k in ("parent", "dist"):
        np.testing.assert_array_equal(res.result[k], base.result[k])


# ------------------------------------------------------ resident bytes
@pytest.mark.parametrize("case", ["sparse", "hybrid", "streamed", "other-store"])
def test_resident_bytes(stores, case):
    """Equal to the reference's on every kind of plan.  The port's
    in-core context with dense tiles also holds the tiles' extents, two
    (nd,) int32 vectors, which the price leaves out."""
    sr, sp = _pair(rc.rmat(8, 8, seed=3))       # no tiles materialized yet
    kw = dict(SPARSE, memory_budget="40KB") if case == "streamed" else (
        HYBRID if case == "hybrid" else SPARSE)
    rplan = rc.compile_plan(ra.pagerank_algorithm(), sr, backend="xla", **kw)
    plan = compile_plan(pa.pagerank_algorithm(), sp, device="cpu", **kw)
    if case == "other-store":
        sr2, sp2 = stores["perm"]
        want = r_tree_array_bytes(rplan.bind(sr2).context)
        got = context_bytes(plan.bind(sp2).context)
    else:
        want, got = rplan.resident_device_bytes, plan.resident_device_bytes
    assert got == want
    if case == "hybrid":
        nd = plan.context.tiles.shape[0]
        assert tuple(plan.context.tile_rows.shape) == (nd,)
        assert tree_array_bytes(plan.context) == got + 2 * 4 * nd


def test_server_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.GraphServer()
    srv = ps.GraphServer(device="cpu")
    with pytest.raises(TypeError, match="server's device"):
        srv.register_graph("web", None, device="cpu")


def test_resolve_accepts_exactly_the_reference_kinds():
    from repro.serve.graphserve import _resolve as r_resolve
    from repro_torch.serve.graphserve import _resolve

    for kind, params in (("pagerank", dict(seeds=[1], tol=1e-3)), ("bfs", dict(source=3)),
                         ("kcore", dict(k=4)), ("cc", dict(k_rounds=3))):
        got, want = _resolve(kind, params), r_resolve(kind, params)
        assert got.key == want.key and got.batchable == want.batchable
    for kind, params in (("tc", {}), ("pagerank", dict(alpha=1)), ("kcore", dict(k=2, x=1))):
        with pytest.raises(ValueError):
            _resolve(kind, params)
        with pytest.raises(ValueError):
            r_resolve(kind, params)
