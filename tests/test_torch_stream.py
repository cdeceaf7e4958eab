"""The port's out-of-core streaming executor on the CPU: the same waves
as the JAX package's on the same store and budget, streamed results
equal to in-core results, and the planning and staging pieces
(footprint model, wave packing, hoisting, CSR slices, rebalancing, the
staging arena and pipeline).

Tolerances: integer and bool results are identical; PageRank and HITS
sum float32 partials in another order and agree to rtol 1e-5 / atol
1e-7 (the reference streaming tests' tolerance).  Wave counts, the task
lists of each wave and the staged bytes of each wave are integers and
must equal the reference's.  Where the reference counts jit traces, the
port counts distinct wave-slab shapes (eager PyTorch traces nothing).
"""
import sys
import threading

import numpy as np
import pytest
import torch

import repro.algorithms as ra
import repro.core as rc
from repro.algorithms.tc import orient_dag as r_orient_dag

import repro_torch.algorithms as pa
from repro_torch.core import (
    BlockAlgorithm, MemoryBudget, StreamingPlan, build_block_store, build_schedule,
    build_waves, choose_p, compile_plan, csr_prefix, rmat, task_footprints,
)
from repro_torch.core import stream as stream_mod
from repro_torch.core.membudget import (
    COO_EDGE_BYTES, CSR_INDEX_BYTES, bucket_size, parse_bytes, repack_waves,
    task_csr_edge_counts, tile_bytes,
)
from repro_torch.algorithms.tc import orient_dag

from test_torch_algorithms import _carry

HYBRID = dict(mode="hybrid", dense_density=0.001, tile_dim=128)
SPARSE = dict(mode="sparse_only")

#: (name, reference factory, port factory, plan kwargs, budget) — the
#: reference streaming tests' table (tests/test_stream.py ALGORITHMS)
ALGORITHMS = [
    ("pagerank", ra.pagerank_algorithm, pa.pagerank_algorithm, HYBRID, "90KB"),
    ("sv", ra.sv_algorithm, pa.sv_algorithm, SPARSE, "16KB"),
    ("afforest", ra.afforest_algorithm, pa.afforest_algorithm, SPARSE, "16KB"),
    ("bfs", lambda: ra.bfs_algorithm(0), lambda: pa.bfs_algorithm(0), HYBRID, "90KB"),
    ("kcore3", lambda: ra.kcore_algorithm(3), lambda: pa.kcore_algorithm(3), SPARSE, "16KB"),
    ("hits", ra.hits_algorithm, pa.hits_algorithm, SPARSE, "16KB"),
    ("tc", ra.tc_algorithm, pa.tc_algorithm, HYBRID, "600KB"),
]
IDS = [a[0] for a in ALGORITHMS]


@pytest.fixture(scope="module")
def graph():
    return rc.rmat(8, 8, seed=3)


@pytest.fixture(scope="module")
def stores(graph):
    """name → (reference store, port store) on the same arrays."""
    out = {}
    for name in ("graph", "dag"):
        g = r_orient_dag(graph) if name == "dag" else graph
        sr = rc.build_block_store(g, 4)
        out[name] = (sr, _carry(sr))
    return out


def _port_store(g=None, p=4):
    return build_block_store(g if g is not None else rmat(8, 8, seed=3), p)


def _assert_equivalent(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "fc":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(a, b)


def _assert_results(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equivalent(a[k], b[k])
    else:
        _assert_equivalent(a, b)


@pytest.mark.parametrize("name,r_alg,p_alg,kw,budget", ALGORITHMS, ids=IDS)
def test_streamed_waves_match_reference(name, r_alg, p_alg, kw, budget, stores):
    sr, sp = stores["dag" if name == "tc" else "graph"]
    ref = rc.compile_plan(r_alg(), sr, backend="xla", host_fraction=None,
                          memory_budget=budget, share=False, **kw)
    want = ref.run()
    plan = compile_plan(p_alg(), sp, device="cpu", memory_budget=budget, share=False,
                        host_fraction=None, **kw)
    got = plan.run()
    assert plan.num_waves == ref.num_waves
    for a, b in zip(plan._slabs, ref._slabs):
        np.testing.assert_array_equal(a.wave.task_ids, b.wave.task_ids)
    st, st_ref = got.schedule_stats["streaming"], want.schedule_stats["streaming"]
    for key in ("bytes_per_wave", "csr_bytes_per_wave", "coalesced_segments",
                "edge_buckets", "bytes_staged_total", "edge_free_prefix_bytes"):
        assert st[key] == st_ref[key], key
    assert got.iterations == want.iterations
    _assert_results(got.result, want.result)


@pytest.mark.parametrize("name,r_alg,p_alg,kw,budget", ALGORITHMS, ids=IDS)
def test_streamed_matches_incore(name, r_alg, p_alg, kw, budget):
    g = orient_dag(rmat(8, 8, seed=3)) if name == "tc" else rmat(8, 8, seed=3)
    incore = compile_plan(p_alg(), build_block_store(g, 4), device="cpu", share=False, **kw)
    streamed = compile_plan(p_alg(), build_block_store(g, 4), device="cpu", share=False,
                            memory_budget=budget, **kw)
    assert isinstance(streamed, StreamingPlan)
    r_in, r_st = incore.run(), streamed.run()
    st = r_st.schedule_stats["streaming"]
    if name != "tc":  # tc's task count is small; the others split ≥ 4×
        assert st["num_waves"] >= 4
    assert r_st.iterations == r_in.iterations
    _assert_results(r_in.result, r_st.result)
    assert st["num_waves"] == len(st["bytes_per_wave"])
    assert all(b + w <= st["budget_bytes"]
               for b, w in zip(st["bytes_per_wave"], st["workspace_per_wave"]))
    assert 0.0 <= st["overlap_efficiency"] <= 1.0
    assert st["bytes_staged_total"] >= sum(st["bytes_per_wave"])
    assert st["resident_bytes"] > 0
    assert r_st.schedule_stats["hetero"]["enabled"]     # every algorithm can use the host


def test_streamed_tc_forces_multiple_waves():
    dag = orient_dag(rmat(8, 8, seed=3))
    plan = compile_plan(pa.tc_algorithm(), build_block_store(dag, 4), device="cpu",
                        mode="sparse_only", share=False, memory_budget="32KB")
    res = plan.run()
    assert res.schedule_stats["streaming"]["num_waves"] >= 4
    want = compile_plan(pa.tc_algorithm(), build_block_store(dag, 4), device="cpu",
                        mode="sparse_only", share=False).run().result
    assert res.result == want


def test_streamed_direction_auto_matches_push():
    store = _port_store()
    runs = {d: compile_plan(pa.bfs_algorithm(0), store, device="cpu", direction=d,
                            memory_budget="90KB", **HYBRID).run()
            for d in ("push", "auto")}
    for k in ("parent", "dist"):
        np.testing.assert_array_equal(runs["auto"].result[k], runs["push"].result[k])
    assert "direction" in runs["auto"].schedule_stats


# ------------------------------------------------------------ membudget
def test_parse_bytes():
    assert parse_bytes(12345) == 12345
    assert parse_bytes("64KB") == 64_000
    assert parse_bytes("2MiB") == 2 * 2**20
    assert parse_bytes("1.5kb") == 1500
    with pytest.raises(ValueError):
        parse_bytes("sixty four")
    with pytest.raises(ValueError):
        MemoryBudget(0)


def test_bucket_size_ladder():
    assert [bucket_size(k) for k in (1, 8, 9, 1000, 1025)] == [8, 8, 16, 1024, 2048]


def test_footprint_model_prices_coo_and_tiles():
    store = _port_store()
    alg = pa.pagerank_algorithm()
    sparse_sched = build_schedule(alg, store, mode="sparse_only")
    fp = task_footprints(store, sparse_sched)
    seg = np.diff(store.block_ptr)
    want = seg[sparse_sched.blocklists[:, 0]] * COO_EDGE_BYTES
    np.testing.assert_array_equal(fp, want)
    hybrid_sched = build_schedule(alg, store, **HYBRID)
    fp_h = task_footprints(store, hybrid_sched)
    dense = hybrid_sched.dense_task_mask
    assert dense.any()
    assert (fp_h[dense] >= want[dense] + tile_bytes(128)).all()
    np.testing.assert_array_equal(fp_h[~dense], want[~dense])


def test_footprints_and_waves_equal_reference(stores):
    sr, sp = stores["graph"]
    for kw in (SPARSE, HYBRID):
        r_sched = rc.build_schedule(ra.pagerank_algorithm(), sr, **kw)
        p_sched = build_schedule(pa.pagerank_algorithm(), sp, **kw)
        r_fp, p_fp = rc.task_footprints(sr, r_sched), task_footprints(sp, p_sched)
        np.testing.assert_array_equal(p_fp, r_fp)
        budget = int(p_fp.max()) * 2
        r_w = rc.build_waves(sr, r_sched, rc.MemoryBudget(budget), r_fp)
        p_w = build_waves(sp, p_sched, MemoryBudget(budget), p_fp)
        assert [w.task_ids.tolist() for w in p_w] == [w.task_ids.tolist() for w in r_w]
        assert [w.est_bytes for w in p_w] == [w.est_bytes for w in r_w]


def test_wave_packing_respects_budget_and_covers_all_tasks():
    store = _port_store()
    sched = build_schedule(pa.pagerank_algorithm(), store, mode="sparse_only")
    fp = task_footprints(store, sched)
    budget = MemoryBudget(int(fp.max()) * 2)
    waves = build_waves(store, sched, budget, fp)
    assert len(waves) >= 2
    for w in waves:
        assert fp[w.task_ids].sum() <= budget.total_bytes
        assert w.est_bytes == fp[w.task_ids].sum()
        lead = sched.blocklists[w.task_ids, 0]
        assert np.all(np.diff(lead) >= 0)       # sorted for coalesced staging
    all_ids = np.concatenate([w.task_ids for w in waves])
    assert sorted(all_ids.tolist()) == list(range(sched.num_tasks))


def test_oversized_task_raises():
    with pytest.raises(ValueError, match="budget"):
        compile_plan(pa.pagerank_algorithm(), _port_store(), device="cpu",
                     mode="sparse_only", share=False, memory_budget=64)


def test_padded_single_task_overflow_raises_not_oversubscribes():
    store = _port_store()
    sched = build_schedule(pa.pagerank_algorithm(), store, mode="sparse_only")
    budget = int(task_footprints(store, sched).max()) + 1
    try:
        plan = compile_plan(pa.pagerank_algorithm(), store, device="cpu",
                            mode="sparse_only", share=False, memory_budget=budget)
    except ValueError:
        return  # an honest refusal...
    st = plan.run().schedule_stats["streaming"]  # ...or every wave fits
    assert all(b <= st["budget_bytes"] for b in st["bytes_per_wave"])


def test_hoisted_extras_do_not_count_against_budget():
    store = _port_store()
    sched = build_schedule(pa.pagerank_algorithm(), store, mode="sparse_only")
    seg = np.diff(store.block_ptr)[sched.blocklists[:, 0]]
    max_padded_slab = int(max(bucket_size(int(e)) for e in seg)) * COO_EDGE_BYTES
    plan = compile_plan(pa.pagerank_algorithm(), store, device="cpu", mode="sparse_only",
                        share=False, memory_budget=max_padded_slab + 200)
    assert plan._hoisted and set(plan._resident.extras) == {"inv_deg", "dangling"}
    res = plan.run()
    st = res.schedule_stats["streaming"]
    assert all(b <= st["budget_bytes"] for b in st["bytes_per_wave"])
    assert abs(float(res.result.sum()) - 1.0) < 1e-3


def test_edge_free_iterations_stage_one_wave():
    store = _port_store()
    plan = compile_plan(pa.afforest_algorithm(), store, device="cpu", mode="sparse_only",
                        share=False, memory_budget="16KB")
    res = plan.run()
    st = res.schedule_stats["streaming"]
    bpw = st["bytes_per_wave"]
    k_rounds = 2
    n_final = res.iterations - k_rounds
    assert n_final >= 1
    prefix_bytes = (store.n + 1) * 8 + store.n * k_rounds * 4
    assert st["edge_free_prefix_bytes"] == prefix_bytes
    assert st["bytes_staged_total"] == prefix_bytes + bpw[0] + (n_final + 1) * sum(bpw)
    want = compile_plan(pa.afforest_algorithm(), _port_store(), device="cpu",
                        mode="sparse_only", share=False).run().result
    np.testing.assert_array_equal(res.result, want)


def test_streaming_plan_is_bound_to_its_store():
    plan = compile_plan(pa.pagerank_algorithm(), _port_store(), device="cpu",
                        mode="sparse_only", share=False, memory_budget="64KB")
    with pytest.raises(TypeError, match="bound to the store"):
        plan.run(_port_store())


def test_wave_slabs_stay_bucketed():
    plan = compile_plan(pa.pagerank_algorithm(), _port_store(), device="cpu",
                        mode="sparse_only", share=False, memory_budget="16KB")
    st = plan.run().schedule_stats["streaming"]
    assert st["num_waves"] >= 4
    assert len(st["edge_buckets"]) <= 3
    assert all(b == bucket_size(b) for b in st["edge_buckets"])
    assert st["slab_shapes"] <= len(st["edge_buckets"]) + 1
    assert plan.compile_count == st["trace_count"] == 1


def test_compile_plan_without_device_raises_on_a_cardless_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_plan(pa.pagerank_algorithm(), _port_store(), memory_budget="64KB")


# ------------------------------------------------------- CSR streaming
def test_csr_slices_round_trip():
    store = _port_store()
    p = store.p
    blocks = np.asarray([0, 1, 5, 6, 10, 15])
    sliced, rbp, indptr, segments = store.csr_slices(blocks)
    touched = np.zeros((p, p), bool)
    gi, gj = np.divmod(blocks, p)
    touched[gi, gj] = True
    stripe_of = np.repeat(np.arange(p), np.diff(store.layout.cuts))
    total = 0
    for u in range(store.n):
        for k in range(p):
            lo, hi = rbp[u, k], rbp[u, k + 1]
            if touched[stripe_of[u], k]:
                np.testing.assert_array_equal(
                    sliced[lo:hi],
                    store.indices[store.row_block_ptr[u, k]:store.row_block_ptr[u, k + 1]])
                total += hi - lo
            else:
                assert lo == hi
    assert total == sliced.size
    assert indptr[0] == 0 and indptr[-1] == sliced.size
    assert sum(e - s for s, e in segments) == sliced.size


def test_csr_slices_and_segments_equal_reference(stores):
    sr, sp = stores["graph"]
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.choice(16, int(rng.integers(0, 16)), replace=False)
        assert sp.edge_segments(ids) == sr.edge_segments(ids)
        for a, b in zip(sp.csr_slices(ids), sr.csr_slices(ids)):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    sliced, rbp, indptr, _ = sp.csr_slices(np.arange(16))
    np.testing.assert_array_equal(sliced, sp.indices)
    np.testing.assert_array_equal(indptr, sp.indptr)


def test_csr_prefix_first_k_neighbors(stores):
    sr, sp = stores["graph"]
    pptr, pidx = csr_prefix(sp.indptr, sp.indices, 3)
    r_ptr, r_idx = rc.csr_prefix(sr.indptr, sr.indices, 3)
    np.testing.assert_array_equal(pptr, r_ptr)
    np.testing.assert_array_equal(pidx, r_idx)
    assert pidx.shape == (sp.n * 3,)
    for u in (0, 1, sp.n // 2, sp.n - 1):
        d = min(int(sp.degrees[u]), 3)
        np.testing.assert_array_equal(pidx[u * 3:u * 3 + d],
                                      sp.indices[sp.indptr[u]:sp.indptr[u] + d])


def _csr_checksum_algorithm():
    """A csr='slice' algorithm that sums every staged adjacency entry
    through positions computed from the (per-wave rebased)
    ``row_block_ptr``: a rebasing error breaks the exact checksum."""

    def prepare(store, sched):
        p, rbp, cuts = store.p, store.row_block_ptr, store.layout.cuts
        starts, lens = [], []
        for b in sched.blocklists[:, 0]:
            i, j = divmod(int(b), p)
            rows = np.arange(cuts[i], cuts[i + 1])
            s, ln = rbp[rows, j], rbp[rows, j + 1] - rbp[rows, j]
            starts.append(s[ln > 0])
            lens.append(ln[ln > 0])
        s, ln = np.concatenate(starts), np.concatenate(lens)
        return dict(csr_starts=s, csr_lens=ln,
                    csr_dp=int(bucket_size(int(ln.max()) if ln.size else 1, minimum=1)))

    def kernel(ctx, state, it):
        s, ln, dp = ctx.extras["csr_starts"], ctx.extras["csr_lens"], ctx.extras["csr_dp"]
        m = ctx.indices.shape[0]          # the staged slice's length
        depth = torch.arange(dp)
        vals = ctx.indices[(s[:, None] + depth).clamp_max(m - 1)]
        tot = torch.where(depth[None, :] < ln[:, None], vals, 0).sum()
        return dict(state, total=state["total"] + tot)

    return BlockAlgorithm(
        name="csr_checksum", kernel_sparse=kernel, prepare=prepare,
        init_state=lambda store: dict(total=np.int64(0)),
        finalize=lambda store, state: int(state["total"]),
        metadata=dict(combine="add", csr="slice"))


def test_streamed_csr_bounded_on_skewed_rmat():
    store = build_block_store(rmat(10, 16, seed=5), 8)
    assert store.indices.nbytes > parse_bytes("32KB")
    plan = compile_plan(_csr_checksum_algorithm(), store, device="cpu", share=False,
                        memory_budget="32KB")
    res = plan.run()
    st = res.schedule_stats["streaming"]
    assert st["csr_mode"] == "slice" and st["num_waves"] >= 4
    assert all(b <= st["budget_bytes"] for b in st["bytes_per_wave"])
    assert 0 < max(st["csr_bytes_per_wave"]) < store.indices.nbytes
    vertex_level = (store.indptr.nbytes + store.degrees.nbytes
                    + store.row_block_ptr.nbytes + store.layout.cuts.nbytes)
    assert st["resident_bytes"] < vertex_level + 1024
    assert res.result == int(store.indices.sum())
    assert compile_plan(_csr_checksum_algorithm(), store, device="cpu",
                        share=False).run().result == res.result


def test_task_csr_edge_counts_dedups_blocks():
    store = _port_store()
    sched = build_schedule(pa.pagerank_algorithm(), store, mode="sparse_only")
    seg = np.diff(store.block_ptr)[sched.blocklists[:, 0]]
    np.testing.assert_array_equal(task_csr_edge_counts(store, sched), seg)
    np.testing.assert_array_equal(task_footprints(store, sched, stage_csr=True),
                                  seg * (COO_EDGE_BYTES + CSR_INDEX_BYTES))


def test_prepare_declared_workspace_is_priced_not_staged():
    store = build_block_store(orient_dag(rmat(8, 8, seed=3)), 4)
    plan = compile_plan(pa.tc_algorithm(), store, device="cpu", mode="sparse_only",
                        share=False, memory_budget="32KB")
    assert any(s.workspace_bytes > 0 for s in plan._slabs)
    for s in plan._slabs:
        assert s.workspace_bytes + s.staged_bytes <= plan.budget.total_bytes
        assert "__workspace_bytes__" not in (s.extras or {})
    incore = compile_plan(pa.tc_algorithm(), store, device="cpu", mode="sparse_only",
                          share=False)
    assert "__workspace_bytes__" not in incore.context.extras


@pytest.mark.parametrize("arg,value", [("rebalance_threshold", 1.5), ("pipeline_depth", 2),
                                       ("host_fraction", 0.5)])
def test_streaming_arguments_require_budget(arg, value):
    with pytest.raises(ValueError, match="memory_budget"):
        compile_plan(pa.pagerank_algorithm(), _port_store(), device="cpu", **{arg: value})


@pytest.mark.parametrize("host_fraction", ["auto", None, 0.0])
def test_host_fraction_without_a_share_runs_device_only(host_fraction, monkeypatch):
    # "auto" peels only once a calibrated device wave exceeds the noise
    # floor: pinned high, so that a slow CPU wave cannot cross it
    monkeypatch.setenv("REPRO_HETERO_NOISE_FLOOR_S", "1e9")
    plan = compile_plan(pa.pagerank_algorithm(), _port_store(), device="cpu",
                        mode="sparse_only", memory_budget="64KB", host_fraction=host_fraction)
    hetero = plan.run().schedule_stats["hetero"]
    assert hetero["host_tasks"] == 0 and hetero["host_tasks_executed"] == 0
    assert hetero["enabled"] == (host_fraction is not None)


# ------------------------------------------------- budget-aware schedule
def test_budget_aware_schedule_shrinks_tiles_and_demotes(stores):
    sr, store = stores["graph"]
    free = build_schedule(pa.pagerank_algorithm(), store, **HYBRID)
    assert free.dense_task_mask.any()
    for budget in ("20KB", "18KB", "90KB"):
        got = build_schedule(pa.pagerank_algorithm(), store, memory_budget=budget, **HYBRID)
        want = rc.build_schedule(ra.pagerank_algorithm(), sr, memory_budget=budget, **HYBRID)
        assert got.stats == want.stats
        np.testing.assert_array_equal(got.dense_task_mask, want.dense_task_mask)
    tight = build_schedule(pa.pagerank_algorithm(), store, memory_budget="20KB", **HYBRID)
    assert tight.tile_dim < 128 and tight.stats["budget_bytes"] == 20_000
    tiny = build_schedule(pa.pagerank_algorithm(), store, memory_budget="18KB", **HYBRID)
    assert not tiny.dense_task_mask.any()


def test_choose_p_bounds_stripe_edges_as_the_reference(graph):
    g = rmat(8, 8, seed=3)
    for budget in ("4KB", "16KB", "64KB", "1GB"):
        assert choose_p(g, budget) == rc.choose_p(graph, budget)
    p = choose_p(g, "16KB")
    assert p > 1
    heaviest = build_block_store(g, p).layout.max_stripe_edges(g)
    cap = 16_000 // (2 * (COO_EDGE_BYTES + CSR_INDEX_BYTES))
    assert heaviest <= max(cap, int(g.degrees.max()))
    assert choose_p(g, "1GB") == 1


def test_schedule_restrict_subsets():
    sched = build_schedule(pa.pagerank_algorithm(), _port_store(), **HYBRID)
    ids = np.asarray([0, 3, 5])
    sub = sched.restrict(ids)
    assert sub.num_tasks == 3
    np.testing.assert_array_equal(sub.blocklists, sched.blocklists[ids])
    np.testing.assert_array_equal(sub.weights, sched.weights[ids])
    want = (np.unique(sched.blocklists[ids][sched.dense_task_mask[ids]])
            if sched.dense_task_mask[ids].any() else np.zeros(0))
    np.testing.assert_array_equal(sub.dense_block_ids, want)


# ------------------------------------------------------- rebalancing
def _pagerank_16kb(**kw):
    return compile_plan(pa.pagerank_algorithm(), _port_store(), device="cpu",
                        mode="sparse_only", share=False, memory_budget="16KB", **kw)


def _want_pagerank():
    return compile_plan(pa.pagerank_algorithm(), _port_store(), device="cpu",
                        mode="sparse_only", share=False).run().result


def test_rebalance_triggers_on_skew():
    plan = _pagerank_16kb(rebalance_threshold=1.5)
    nw = plan.num_waves
    assert nw >= 4
    before = np.concatenate([s.wave.task_ids for s in plan._slabs])
    assert plan.rebalance([1.0] * (nw - 1) + [10.0 * nw]) is True
    after = np.concatenate([s.wave.task_ids for s in plan._slabs])
    assert sorted(after.tolist()) == sorted(before.tolist())
    assert all(s.staged_bytes + s.workspace_bytes <= plan.budget.total_bytes
               for s in plan._slabs)
    res = plan.run()
    assert res.schedule_stats["streaming"]["rebalanced"] is True
    np.testing.assert_allclose(res.result, _want_pagerank(), rtol=1e-5, atol=1e-7)


def test_rebalance_ignores_balanced_waves():
    plan = _pagerank_16kb(rebalance_threshold=1.5)
    assert plan.rebalance([1.0] * plan.num_waves) is False and not plan._rebalanced
    off = _pagerank_16kb(rebalance_threshold=None)
    assert off.rebalance([1.0] * (off.num_waves - 1) + [100.0]) is False


def test_auto_rebalance_fires_on_divergence_with_hysteresis():
    plan = _pagerank_16kb()
    assert plan.rebalance_threshold == "auto"
    nw = plan.num_waves
    assert plan.rebalance([0.1] * (nw - 1) + [nw * 1.0]) is True
    assert plan._rebalanced and not plan._reb_armed
    nw2 = plan.num_waves
    assert plan.rebalance([0.1] * (nw2 - 1) + [nw2 * 1.0]) is False   # no thrash
    assert plan.rebalance([0.1] * nw2) is False and plan._reb_armed   # re-armed
    res = plan.run()
    st = res.schedule_stats["streaming"]
    assert st["rebalanced"] and st["rebalance_mode"] == "auto"
    assert st["rebalance_divergence"] is not None
    np.testing.assert_allclose(res.result, _want_pagerank(), rtol=1e-5, atol=1e-7)


def test_auto_rebalance_noise_floor():
    plan = _pagerank_16kb()
    nw = plan.num_waves
    assert plan.rebalance([1e-4] * (nw - 1) + [1e-3 * nw]) is False
    assert plan.rebalance([0.1] * nw) is False
    assert plan._rebalanced is False


def test_repack_waves_balances_time_under_budget():
    store = _port_store()
    sched = build_schedule(pa.pagerank_algorithm(), store, mode="sparse_only")
    fp = task_footprints(store, sched)
    budget = MemoryBudget(int(fp.max()) * 3)
    t = np.ones(sched.num_tasks)
    t[0] = 50.0
    waves = repack_waves(sched, budget, fp, t)
    assert all(fp[w.task_ids].sum() <= budget.total_bytes for w in waves)
    heavy = [w for w in waves if 0 in w.task_ids.tolist()]
    assert len(heavy) == 1 and heavy[0].task_ids.size == 1
    assert sorted(np.concatenate([w.task_ids for w in waves]).tolist()) == \
        list(range(sched.num_tasks))


# ------------------------------------------------- pipeline + slab shapes
SHAPE_ALGORITHMS = [
    ("pagerank", pa.pagerank_algorithm, "24KB"),
    ("sv", pa.sv_algorithm, "24KB"),
    ("afforest", pa.afforest_algorithm, "24KB"),
    ("bfs", lambda: pa.bfs_algorithm(0), "24KB"),
    ("kcore3", lambda: pa.kcore_algorithm(3), "24KB"),
    ("hits", pa.hits_algorithm, "24KB"),
    ("tc", pa.tc_algorithm, "64KB"),
]


@pytest.mark.parametrize("name,alg_f,budget", SHAPE_ALGORITHMS,
                         ids=[a[0] for a in SHAPE_ALGORITHMS])
def test_few_distinct_slab_shapes(name, alg_f, budget):
    g = rmat(9, 8, seed=3)
    g = orient_dag(g) if name == "tc" else g
    plan = compile_plan(alg_f(), build_block_store(g, 4), device="cpu", share=False,
                        memory_budget=budget, mode="sparse_only")
    res = plan.run()
    st = res.schedule_stats["streaming"]
    assert st["num_waves"] >= 6
    assert st["slab_shapes"] < st["num_waves"]
    assert plan.compile_count == 1
    want = compile_plan(alg_f(), build_block_store(g, 4), device="cpu", share=False,
                        mode="sparse_only").run().result
    _assert_results(res.result, want)


def test_tc_slab_shapes_independent_of_wave_count():
    dag = orient_dag(rmat(10, 8, seed=5))
    runs = {}
    for budget in ("512KB", "128KB"):
        plan = compile_plan(pa.tc_algorithm(), build_block_store(dag, 8), device="cpu",
                            mode="sparse_only", share=False, memory_budget=budget)
        res = plan.run()
        ws = {r.workspace_bytes for r in plan._slabs}
        assert len(ws) == 1 and ws.pop() > 0
        for r in plan._slabs:
            assert "__workspace_bytes__" not in (r.extras or {})
            assert r.staged_bytes + r.workspace_bytes <= plan.budget.total_bytes
        st = res.schedule_stats["streaming"]
        runs[budget] = (res.result, st["num_waves"], st["slab_shapes"])
    (c1, w1, _), (c2, w2, d2) = runs["512KB"], runs["128KB"]
    assert c1 == c2
    assert w2 >= 2 * w1
    assert d2 <= max(w2 // 2, 3)


def test_pipeline_depth_zero_is_synchronous_and_identical():
    runs = {}
    for depth in (2, 0):
        plan = compile_plan(pa.sv_algorithm(), _port_store(), device="cpu",
                            mode="sparse_only", share=False, memory_budget="16KB",
                            pipeline_depth=depth)
        st = (res := plan.run()).schedule_stats["streaming"]
        assert st["pipeline_depth"] == depth
        if depth == 0:
            assert st["host_stage_overlap"] == 0.0
        runs[depth] = res.result
    np.testing.assert_array_equal(runs[2], runs[0])


def test_arena_and_phase_stats():
    st = _pagerank_16kb().run().schedule_stats["streaming"]
    assert st["num_waves"] >= 4
    assert st["arena_bytes"] > 0 and st["arena_reuses"] > 0
    assert st["arena_model_bytes"] >= max(st["bytes_per_wave"])
    assert 0.0 <= st["host_stage_overlap"] <= 1.0
    phases = st["phase_seconds"]
    assert set(phases) == set(stream_mod.PHASES)
    assert all(v >= 0.0 for v in phases.values())
    assert phases["assemble"] > 0.0 and phases["device_put"] > 0.0
    assert st["h2d_bytes"] == 0      # the CPU copies nothing


class _Pending:
    """A copy event that has not landed until ``landed`` is set."""

    def __init__(self):
        self.landed = False

    def query(self):
        return self.landed

    def synchronize(self):
        self.landed = True


def test_arena_buffers_return_only_after_their_copy_landed():
    plan = _pagerank_16kb()
    slab = plan._assemble_runtime(plan._slabs[0], wave=0)
    ev = _Pending()
    plan._park_for_recycle(slab, stream_mod._Staged({}, None, [ev]))
    plan._drain_recycle()
    assert plan._arena_deferred, "a buffer went back while its copy was in flight"
    ev.landed = True
    plan._drain_recycle()
    assert not plan._arena_deferred
    buf = slab.arena_arrays[0]
    assert any(a is buf for a in plan._arena._free[(buf.shape, buf.dtype.str)])


def test_worker_death_reraises_its_exception(monkeypatch):
    plan = _pagerank_16kb()
    plan.run()          # calibrated: the next run stages in the worker
    real = plan._assemble_runtime

    def failing(recipe, *, wave=-1):
        if threading.current_thread().name == "repro-staging":
            raise MemoryError("gather failed")
        return real(recipe, wave=wave)

    monkeypatch.setattr(plan, "_assemble_runtime", failing)
    # with no retry left, the worker's exception surfaces wrapped in a
    # WorkerDeath that carries it
    from repro_torch.core import RetryPolicy, WorkerDeath

    plan._policy = RetryPolicy(max_retries=0)
    with pytest.raises(WorkerDeath, match="gather failed") as err:
        plan.run()
    assert isinstance(err.value.cause, MemoryError)
    assert plan._pipe is None
    # with retries, the iteration fails over to synchronous assembly on
    # the main thread and the run completes
    plan._policy = RetryPolicy()
    res = plan.run()
    np.testing.assert_allclose(res.result, _want_pagerank(), rtol=1e-5, atol=1e-7)
    assert res.schedule_stats["resilience"]["failovers"] >= 1


def test_waves_pass_the_block_rectangles_to_the_tile_kernel(monkeypatch):
    port_pagerank = sys.modules["repro_torch.algorithms.pagerank"]
    calls = []
    real = port_pagerank.spmv_tiles

    def recording(tiles, xs, extents=None):
        calls.append((tiles, extents))
        return real(tiles, xs, extents)

    monkeypatch.setattr(port_pagerank, "spmv_tiles", recording)
    store = _port_store()
    plan = compile_plan(pa.pagerank_algorithm(max_iters=1), store, device="cpu",
                        memory_budget="90KB", **HYBRID)
    plan.run()
    dense = [r for r in plan._slabs if r.run_dense]
    assert dense and len(calls) == 2 * len(dense)   # warm-up + timed pass
    for (tiles, (rows, cols)), recipe in zip(calls, dense * 2):
        ids = plan.schedule.restrict(recipe.wave.task_ids).dense_block_ids
        want_r, want_c = store.tile_extents(ids)
        assert rows.dtype == torch.int32 and rows.shape == (tiles.shape[0],)
        np.testing.assert_array_equal(rows[:recipe.nd].numpy(), want_r)
        np.testing.assert_array_equal(cols[:recipe.nd].numpy(), want_c)
        assert not rows[recipe.nd:].any() and not cols[recipe.nd:].any()
        assert int(rows.max()) <= plan.schedule.tile_dim


#: the failing example of the reference's
#: test_direction_property.py::test_auto_never_exceeds_memory_budget
#: (budget "6KB", p=1): 63 vertices, vertex 0 joined to 11..62 but 19,
#: and these 78 edges (from_edges symmetrizes them)
_HUB_EDGES = [
    (11, 21), (11, 32), (11, 40), (12, 23), (12, 31), (13, 25), (13, 38), (13, 57), (14, 17),
    (14, 24), (14, 26), (14, 38), (14, 41), (15, 33), (15, 55), (16, 29), (16, 34), (16, 39),
    (16, 42), (17, 22), (17, 23), (17, 33), (17, 44), (17, 60), (18, 19), (18, 26), (19, 23),
    (19, 60), (20, 50), (21, 39), (21, 55), (22, 44), (23, 29), (24, 26), (24, 29), (25, 41),
    (25, 42), (26, 48), (26, 50), (27, 35), (27, 38), (27, 44), (29, 35), (29, 60), (30, 40),
    (31, 41), (31, 47), (32, 36), (32, 45), (34, 36), (34, 43), (34, 59), (35, 44), (35, 54),
    (36, 56), (36, 57), (36, 61), (37, 48), (37, 56), (39, 50), (39, 60), (39, 62), (40, 43),
    (40, 50), (40, 53), (41, 48), (41, 52), (41, 57), (43, 56), (44, 48), (45, 48), (47, 58),
    (47, 61), (48, 60), (54, 58), (54, 60), (57, 62), (59, 61),
]


def test_single_task_over_budget_matches_reference():
    """A reference fault the port reproduces (ROADMAP C): on this hub
    graph at p=1 the one task's bucket-padded slab plus SV's prepare
    extras exceed a 6KB budget although its modelled footprint fits, so
    planning raises instead of staging the wave.  Both packages raise
    the same ``ValueError`` (``repro/core/membudget.py:643``)."""
    hub = [(0, v) for v in range(11, 63) if v != 19]
    src, dst = np.array(hub + _HUB_EDGES).T
    gr = rc.from_edges(src, dst, n=63)
    assert gr.n == 63 and int(np.diff(gr.indptr)[0]) == 51 and gr.m == 258
    with pytest.raises(ValueError, match="single task's staged bytes") as want:
        rc.compile_plan(ra.sv_algorithm(), rc.build_block_store(gr, 1), memory_budget="6KB",
                        direction="auto")
    store = _carry(rc.build_block_store(gr, 1))
    with pytest.raises(ValueError, match="single task's staged bytes") as got:
        compile_plan(pa.sv_algorithm(), store, device="cpu", memory_budget="6KB",
                     direction="auto")
    assert str(got.value) == str(want.value)
    # a budget above the padded slab runs, and equals in-core
    res = compile_plan(pa.sv_algorithm(), store, device="cpu", memory_budget="12KB",
                       direction="auto").run()
    want_labels = compile_plan(pa.sv_algorithm(), store, device="cpu").run().result
    np.testing.assert_array_equal(res.result, want_labels)
