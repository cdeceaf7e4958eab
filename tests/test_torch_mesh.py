"""The port's device mesh on the CPU, against the JAX package.

Three layers, as in the reference's ``tests/test_mesh_stream.py``:

* host-side units on one store carried across with ``repro_torch.interop``:
  the per-shard edge partition (all blocks of multi-block tasks, bucket
  padding, CSR slabs), mesh-capacity wave packing, the ``choose_p``
  device floor and per-device workspace pricing equal the reference's;
* the mesh executors in this process, one controller over
  ``DeviceMesh(["cpu"] * D)`` shards, against the port's in-core and
  single-device streamed runs, batched states, ``GraphServer`` and the
  ``mesh.collective`` fault seam;
* one module-scoped subprocess of the reference on an 8-device host
  platform (XLA fixes the device count at its first use), whose results,
  waves, staged bytes, per-device bytes, collective bytes and per-device
  task lists the port's 8-shard runs must equal.

Tolerances: integer and bool results are identical; PageRank and HITS
sum float32 partials in another order (rtol 1e-5 / atol 1e-7, the
reference mesh tests' tolerance).  No test opens a socket, starts a
process group or sleeps.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.algorithms as ra
import repro.core as rc
from repro.algorithms.tc import orient_dag as r_orient_dag
from repro.kernels.registry import workspace_bytes as r_workspace_bytes

import repro_torch.algorithms as pa
from repro_torch.algorithms.tc import orient_dag
from repro_torch.core import (
    BlockAlgorithm, DeviceMesh, DistributedEngine, MemoryBudget, batch_states,
    build_block_store, build_schedule, build_waves, choose_p, compile_plan,
    make_device_edge_partition, rmat, task_footprints, unbatch_state,
)
from repro_torch.core.distributed import combine
from repro_torch.core.membudget import bucket_size
from repro_torch.kernels.registry import workspace_bytes
from repro_torch.serve import GraphServer

from test_torch_algorithms import _carry
from test_torch_graph_serve import FIXED_WAVES, _packages, _pair, _results, _transcript

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-7)
HYBRID = dict(mode="hybrid", dense_density=0.001, tile_dim=128)
SPARSE = dict(mode="sparse_only")

#: (name, port factory, plan kwargs, budget) on rmat(8, 8, seed=3), p=4
#: (TC on its DAG): the single-device streaming tests' table.  HITS runs a
#: fixed count (negative tol): at its default 1e-8 the float32 delta sits
#: at its noise floor and the summation order picks the stopping
#: iteration (ROADMAP C)
ALGORITHMS = [
    ("pagerank", pa.pagerank_algorithm, HYBRID, "90KB"),
    ("sv", pa.sv_algorithm, SPARSE, "16KB"),
    ("afforest", pa.afforest_algorithm, SPARSE, "16KB"),
    ("bfs", lambda: pa.bfs_algorithm(0), dict(HYBRID, direction="auto"), "90KB"),
    ("kcore3", lambda: pa.kcore_algorithm(3), SPARSE, "16KB"),
    ("hits", lambda: pa.hits_algorithm(tol=-1.0, max_iters=20), SPARSE, "16KB"),
    ("tc", pa.tc_algorithm, HYBRID, "600KB"),
]


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "fc":
        np.testing.assert_allclose(a, b, **TOL)
    else:
        np.testing.assert_array_equal(a, b)


def _cpu_mesh(d):
    return DeviceMesh(["cpu"] * d)


@pytest.fixture(scope="module")
def graph():
    return rc.rmat(8, 8, seed=3)


# ------------------------------------------------------- host-side units
@pytest.mark.parametrize("name,p,d,kw", [
    ("tc", 4, 4, {}),
    ("pagerank", 8, 8, {}),
    ("pagerank", 4, 4, dict(bucket=True, stage_csr=True)),
], ids=["tc-multiblock", "pagerank-single-block", "pagerank-bucket-csr"])
def test_partition_matches_reference(graph, name, p, d, kw):
    g = r_orient_dag(graph) if name == "tc" else graph
    sr = rc.build_block_store(g, p)
    sp = _carry(sr)
    r_alg, p_alg = ((ra.tc_algorithm, pa.tc_algorithm) if name == "tc"
                    else (ra.pagerank_algorithm, pa.pagerank_algorithm))
    rs = rc.build_schedule(r_alg(), sr, num_devices=d, mode="sparse_only")
    ps = build_schedule(p_alg(), sp, num_devices=d, mode="sparse_only")
    np.testing.assert_array_equal(ps.device_assignment, rs.device_assignment)
    want = rc.make_device_edge_partition(sr, rs, **kw)
    got = make_device_edge_partition(sp, ps, **kw)
    arrays = ["src", "dst", "edge_block", "valid"] + (["indices"] if "stage_csr" in kw else [])
    for k in arrays:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("edges", "segments") + (("csr_entries", "csr_segments") if "stage_csr" in kw
                                      else ()):
        assert got[k] == want[k], k
    for a, b in zip(got["blocks"], want["blocks"]):
        np.testing.assert_array_equal(a, b)
    # the reference tests' properties: every block of every task of a
    # shard is staged on it; single-block tasks cover each edge once; the
    # bucketed widths lie on the ladder, each CSR slab is its shard's slices
    for dev in range(d):
        staged = {int(b) for b in got["blocks"][dev]}
        for t in np.nonzero(ps.device_assignment == dev)[0]:
            assert {int(b) for b in ps.blocklists[t]} <= staged
    if name == "pagerank" and not kw:
        assert int(got["valid"].sum()) == sp.m
    if "stage_csr" in kw:
        assert got["src"].shape[1] == bucket_size(got["src"].shape[1])
        assert got["indices"].shape[1] == bucket_size(got["indices"].shape[1])
        for dev in range(d):
            sl, _, _, _ = sp.csr_slices(got["blocks"][dev])
            n = got["csr_entries"][dev]
            np.testing.assert_array_equal(got["indices"][dev, :n], sl)
            assert not got["indices"][dev, n:].any()
        for (a0, a1), (b0, b1) in zip(got["csr_maps"], want["csr_maps"]):
            np.testing.assert_array_equal(a0, b0)
            np.testing.assert_array_equal(a1, b1)


def test_build_waves_mesh_capacity_matches_reference(graph):
    sr = rc.build_block_store(graph, 4)
    sp = _carry(sr)
    rs = rc.build_schedule(ra.pagerank_algorithm(), sr, mode="sparse_only")
    ps = build_schedule(pa.pagerank_algorithm(), sp, mode="sparse_only")
    fp = task_footprints(sp, ps)
    np.testing.assert_array_equal(fp, rc.task_footprints(sr, rs))
    budget = MemoryBudget(int(fp.max()) * 2)
    solo = build_waves(sp, ps, budget, fp)
    mesh4 = build_waves(sp, ps, budget, fp, devices=4)
    want = rc.build_waves(sr, rs, rc.MemoryBudget(int(fp.max()) * 2), fp, devices=4)
    assert [w.task_ids.tolist() for w in mesh4] == [w.task_ids.tolist() for w in want]
    assert len(mesh4) < len(solo)
    assert all(fp[w.task_ids].sum() <= budget.total_bytes * 4 for w in mesh4)
    ids = np.concatenate([w.task_ids for w in mesh4])
    assert sorted(ids.tolist()) == list(range(ps.num_tasks))
    # a task is atomic on one shard: the per-task bound does not relax
    with pytest.raises(ValueError, match="per-device budget"):
        build_waves(sp, ps, MemoryBudget(max(int(fp.max()) // 2, 1)), fp, devices=8)


def test_choose_p_devices_floor(graph):
    g = rmat(8, 8, seed=3)
    assert choose_p(g, "1GB") == rc.choose_p(graph, "1GB") == 1
    assert choose_p(g, "1GB", devices=8) == rc.choose_p(graph, "1GB", devices=8) == 4


@pytest.mark.parametrize("name,hints", [
    ("spmv_tiles", dict(nd=8, tile_dim=64)),
    ("frontier_tiles", dict(nd=5, tile_dim=128)),
    ("tc_tiles", dict(nd=7, tile_dim=64)),
    ("csr_bucket_search", dict(items=5, depth=8)),
    ("csr_slice", dict(csr_edges=1001)),
])
def test_registry_per_device_pricing(name, hints):
    for d in (1, 2, 4, 8):
        assert workspace_bytes(name, devices=d, **hints) == r_workspace_bytes(
            name, devices=d, **hints), d
    assert workspace_bytes("spmv_tiles", nd=8, tile_dim=64, devices=4) == workspace_bytes(
        "spmv_tiles", nd=8, tile_dim=64) // 4


# --------------------------------------------------------------- errors
def test_mesh_requires_budget_declaration_and_its_device():
    import jax
    from jax.sharding import Mesh

    sr = rc.build_block_store(rc.rmat(8, 8, seed=3), 4)
    store = _carry(sr)
    mesh = _cpu_mesh(1)
    with pytest.raises(ValueError, match="memory_budget") as want:
        rc.compile_plan(ra.pagerank_algorithm(), sr,
                        mesh=Mesh(np.array(jax.devices()[:1]), ("blocks",)))
    with pytest.raises(ValueError, match="memory_budget") as got:
        compile_plan(pa.pagerank_algorithm(), store, mesh=mesh)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    undeclared = BlockAlgorithm(
        name="mesh_undeclared",
        kernel_sparse=lambda ctx, state, it: dict(
            state, x=state["x"].index_add(0, ctx.dst.long(), torch.ones(ctx.dst.shape[0]))),
        init_state=lambda store: dict(x=np.zeros(store.n, np.float32)),
        metadata=dict(combine="add", csr="none"))
    with pytest.raises(ValueError, match="metadata\\['mesh'\\]"):
        compile_plan(undeclared, store, memory_budget="64KB", mesh=mesh, share=False)
    with pytest.raises(ValueError, match="shard-0 device"):
        compile_plan(pa.pagerank_algorithm(), store, device="cuda:0", memory_budget="64KB",
                     mesh=mesh)
    with pytest.raises(ValueError, match="host_fraction"):
        compile_plan(pa.pagerank_algorithm(), store, memory_budget="64KB", mesh=mesh,
                     host_fraction=0.3)
    # the mesh owns the wave partition: "auto" stays device-only
    plan = compile_plan(pa.pagerank_algorithm(), store, memory_budget="64KB", mesh=mesh)
    assert plan._host_lane is None and not plan.run().schedule_stats["hetero"]["enabled"]


def test_device_mesh_never_places_silently(monkeypatch):
    assert _cpu_mesh(8).size == 8 and _cpu_mesh(8).distinct == (torch.device("cpu"),)
    assert DeviceMesh(["cpu"]).axis_names == ("blocks",)
    with pytest.raises(ValueError):
        DeviceMesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 CUDA devices"):
        DeviceMesh.cuda(4)
    with pytest.raises(RuntimeError, match="cuda:3"):
        DeviceMesh(["cuda:0", "cuda:3"])
    with pytest.raises(ValueError, match="cuda:<index>"):
        DeviceMesh(["cuda"])
    two = DeviceMesh(["cuda:0"] * 2)       # one card listed twice: two shards on it
    assert two.size == 2 and two.distinct == (torch.device("cuda", 0),)


def test_combine_folds_in_shard_order():
    parts = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0]), torch.tensor([2.0, 9.0])]
    base = torch.tensor([1.0, 1.0])
    np.testing.assert_array_equal(combine("add", parts).numpy(), [6.0, 16.0])
    np.testing.assert_array_equal(combine("add", parts, base).numpy(), [4.0, 14.0])
    np.testing.assert_array_equal(combine("min", parts).numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(combine("max", parts).numpy(), [3.0, 9.0])
    with pytest.raises(ValueError, match="unknown combine kind"):
        combine("mean", parts)


# ------------------------------------------------ in-process mesh runs
@pytest.mark.parametrize("d", [1, 2, 8])
@pytest.mark.parametrize("name,alg,kw,budget", ALGORITHMS, ids=[a[0] for a in ALGORITHMS])
def test_mesh_streamed_matches_incore_and_solo_stream(name, alg, kw, budget, d):
    g = orient_dag(rmat(8, 8, seed=3)) if name == "tc" else rmat(8, 8, seed=3)
    incore = compile_plan(alg(), build_block_store(g, 4), device="cpu", share=False,
                          **kw).run()
    solo = compile_plan(alg(), build_block_store(g, 4), device="cpu", share=False,
                        memory_budget=budget, host_fraction=None, **kw).run()
    plan = compile_plan(alg(), build_block_store(g, 4), share=False, memory_budget=budget,
                        mesh=_cpu_mesh(d), **kw)
    assert plan.device == torch.device("cpu")
    meshed = plan.run()
    st = meshed.schedule_stats["streaming"]
    assert st["mesh_devices"] == d and len(st["per_device_bytes"]) == st["num_waves"]
    assert all(b + w <= st["budget_bytes"]
               for b, w in zip(st["per_device_bytes"], st["workspace_per_wave"]))
    assert st["collective_bytes"] > 0 and st["collective_folds"] > 0
    # CPU shards run the plain kernels: no CUDA launch is attributed
    assert st["shard_launches"] == [{} for _ in range(d)] or all(
        not any(x.values()) for x in st["shard_launches"])
    assert meshed.iterations == incore.iterations == solo.iterations
    _same(meshed.result, incore.result)
    _same(meshed.result, solo.result)


def test_mesh_tc_runs_the_tile_kernel_on_every_shard(monkeypatch):
    """TC hybrid: each shard runs the (plain, on the CPU) ``tc_tiles`` on
    its own padded tile set, with the mesh_pack-unified triples."""
    tc_mod = sys.modules["repro_torch.algorithms.tc"]
    calls = []
    real = tc_mod.tc_tiles

    def counting(tiles, idx, extents=None):
        calls.append((tiles.shape[0], int((idx[:, 0] >= 0).sum())))
        return real(tiles, idx, extents)

    monkeypatch.setattr(tc_mod, "tc_tiles", counting)
    store = build_block_store(orient_dag(rmat(8, 8, seed=3)), 4)
    d = 4
    plan = compile_plan(pa.tc_algorithm(), store, share=False, memory_budget="300KB",
                        mesh=_cpu_mesh(d), **HYBRID)
    res = plan.run()
    dense = [r for r in plan._slabs if r.run_dense]
    assert dense, "the configuration must route triples to the tiles"
    # calibration: a warm-up pass and a timed pass over every wave
    assert len(calls) == 2 * d * len(dense)
    assert {nd for nd, _ in calls} == {r.tile_bucket for r in dense}
    assert sum(live for _, live in calls) > 0
    want = compile_plan(pa.tc_algorithm(), build_block_store(orient_dag(rmat(8, 8, seed=3)), 4),
                        device="cpu", share=False, **HYBRID).run().result
    assert res.result == want


def test_mesh_rebalance_keeps_per_device_budget():
    store = build_block_store(rmat(8, 8, seed=3), 8)
    plan = compile_plan(pa.pagerank_algorithm(), store, share=False, memory_budget="8KB",
                        mesh=_cpu_mesh(2), rebalance_threshold=1.5, **SPARSE)
    nw = plan.num_waves
    assert nw >= 2
    assert plan.rebalance([1.0] * (nw - 1) + [10.0 * nw]) is True
    for s in plan._slabs:
        assert s.per_device_bytes + s.workspace_bytes <= plan.budget.total_bytes
    res = plan.run()
    want = compile_plan(pa.pagerank_algorithm(), build_block_store(rmat(8, 8, seed=3), 8),
                        device="cpu", share=False, **SPARSE).run().result
    np.testing.assert_allclose(res.result, want, **TOL)


def test_mesh_collective_fault_recovers():
    store = build_block_store(rmat(8, 8, seed=3), 4)
    kw = dict(share=False, memory_budget="16KB", mesh=_cpu_mesh(2), **SPARSE)
    clean = compile_plan(pa.sv_algorithm(), store, **kw).run()
    res = compile_plan(pa.sv_algorithm(), store, faults="mesh.collective:raise:at(2)",
                       **kw).run()
    rs = res.schedule_stats["resilience"]
    assert rs["injected"] == 1 and rs["detected"] == 1 and rs["retries"] == 1
    np.testing.assert_array_equal(res.result, clean.result)


# ------------------------------------------------------- batch × mesh
@pytest.mark.parametrize("kw", [HYBRID, SPARSE], ids=["hybrid", "sparse"])
def test_batched_pagerank_under_mesh_equals_solo(kw, monkeypatch):
    pr_mod = sys.modules["repro_torch.algorithms.pagerank"]
    batches = []
    real = pr_mod.spmv_tiles

    def counting(tiles, xs, extents=None):
        batches.append(xs.shape[0] if xs.dim() == 3 else 1)
        return real(tiles, xs, extents)

    monkeypatch.setattr(pr_mod, "spmv_tiles", counting)
    store = build_block_store(rmat(8, 8, seed=3), 4)
    seedsets = [[0], [7, 19], [3, 9, 27]]
    mk = dict(FIXED_WAVES, mesh=_cpu_mesh(2), share=False, **kw)
    plan = compile_plan(pa.pagerank_algorithm(), store, **mk)
    res = plan.run(state=batch_states([pa.pagerank_algorithm(seeds=s).init_state(store)
                                       for s in seedsets], pad_to=4))
    if kw is HYBRID:
        # the query axis reaches the tile kernel on every shard
        assert batches and set(batches) == {4} and len(batches) % 2 == 0
    for i, s in enumerate(seedsets):
        solo = compile_plan(pa.pagerank_algorithm(seeds=s), store, **mk).run()
        row = unbatch_state(res.state, i)
        np.testing.assert_array_equal(row["rank"].numpy(), solo.result)
        one = compile_plan(pa.pagerank_algorithm(seeds=s), store, device="cpu",
                           share=False, **kw).run()
        np.testing.assert_allclose(row["rank"].numpy(), one.result, **TOL)


@pytest.mark.parametrize("kw", [dict(HYBRID, direction="auto"), SPARSE],
                         ids=["hybrid-auto", "sparse"])
def test_multi_source_bfs_under_mesh_equals_solo(kw):
    store = build_block_store(rmat(8, 8, seed=3), 4)
    srcs = [3, 11, 42]
    mk = dict(FIXED_WAVES, mesh=_cpu_mesh(4), share=False, **kw)
    got = compile_plan(pa.bfs_algorithm(sources=srcs), store, **mk).run()
    for i, s in enumerate(srcs):
        solo = compile_plan(pa.bfs_algorithm(s), store, device="cpu", share=False,
                            **kw).run().result
        for k in ("parent", "dist"):
            np.testing.assert_array_equal(got.result[k][i], solo[k])


def _meshed_serving(P, mesh):
    store = P.stores["stream"]
    probe = P.compile_plan(P.pagerank(), store, mesh=mesh, **FIXED_WAVES)
    probe_bfs = P.compile_plan(P.bfs(0), store, mesh=mesh, **FIXED_WAVES)
    per_q = P.state_bytes(P.pagerank(seeds=[0]).init_state(store))
    budget = probe.resident_device_bytes + probe_bfs.resident_device_bytes + 3 * per_q
    srv = P.Server(memory_budget=budget, max_batch=8)
    srv.register_graph("web", store, mesh=mesh, **FIXED_WAVES)
    uids = [srv.submit(P.Query("web", "pagerank", dict(seeds=[s]))) for s in range(6)]
    uids += [srv.submit(P.Query("web", "bfs", dict(source=s))) for s in (5, 17)]
    srv.drain()
    return _transcript(srv, uids), _results(srv, uids), probe.resident_device_bytes


def test_graph_server_with_mesh_matches_reference():
    import jax
    from jax.sharding import Mesh

    ref, port = _packages({"stream": _pair(rc.rmat(8, 8, seed=3))})
    ref.bfs, port.bfs = ra.bfs_algorithm, pa.bfs_algorithm
    want, want_res, want_resident = _meshed_serving(
        ref, Mesh(np.array(jax.devices()[:1]), ("blocks",)))
    got, got_res, got_resident = _meshed_serving(port, _cpu_mesh(1))
    assert got == want and got_resident == want_resident
    assert [q["status"] for q in got["queries"]] == ["done"] * 8
    for a, b in zip(got_res, want_res):
        _same(a, b)
    with pytest.raises(ValueError, match="shard-0 device"):
        GraphServer(device="cuda:0").register_graph(
            "web", build_block_store(rmat(8, 8, seed=3), 4), memory_budget="40KB",
            mesh=_cpu_mesh(2))


# ------------------------------------- the reference on 8 host devices
REF8 = """
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import build_block_store, build_schedule, compile_plan, rmat
    from repro.core.distributed import DistributedEngine
    from repro.algorithms import (
        pagerank_algorithm, sv_algorithm, afforest_algorithm, bfs_algorithm,
        kcore_algorithm, hits_algorithm, tc_algorithm)
    from repro.algorithms.tc import orient_dag

    assert len(jax.devices()) == 8, jax.devices()
    mesh = Mesh(np.array(jax.devices()), ("blocks",))
    CASES = json.loads(sys.argv[1])
    FACTORIES = dict(pagerank=pagerank_algorithm, sv=sv_algorithm,
                     afforest=afforest_algorithm, bfs=lambda: bfs_algorithm(0),
                     kcore3=lambda: kcore_algorithm(3),
                     hits=lambda: hits_algorithm(tol=-1.0, max_iters=20), tc=tc_algorithm)
    out = {}
    for name, (graph, p, budget, kw) in CASES.items():
        g = rmat(*graph[:2], seed=graph[2])
        g = orient_dag(g) if name == "tc" else g
        plan = compile_plan(FACTORIES[name](), build_block_store(g, p), share=False,
                            host_fraction=None, rebalance_threshold=None,
                            memory_budget=budget, mesh=mesh, **kw)
        res = plan.run()
        st = res.schedule_stats["streaming"]
        r = res.result
        r = ({k: np.asarray(v).tolist() for k, v in r.items()} if isinstance(r, dict)
             else np.asarray(r).tolist())
        tasks = []
        for s in plan._slabs:
            ids = s.wave.task_ids
            a = plan.schedule.restrict(ids).partition_tasks(8)
            tasks.append([ids[a == i].tolist() for i in range(8)])
        out[name] = dict(result=r, iterations=res.iterations, tasks=tasks,
                         dense=[bool(s.run_dense) for s in plan._slabs],
                         **{k: st[k] for k in ("num_waves", "bytes_per_wave",
                                               "per_device_bytes", "collective_bytes")})

    # the reference's DistributedEngine PageRank (tests/test_distributed.py)
    store = build_block_store(rmat(9, 8, seed=3), 4)
    sched = build_schedule(pagerank_algorithm(), store, num_devices=8, mode="sparse_only")
    inv_deg = jnp.asarray(1.0 / np.maximum(np.diff(store.indptr), 1))
    n = store.n

    def edge_update(src, dst, valid, state):
        contrib = state["rank"] * inv_deg
        vals = jnp.where(valid, contrib[src], 0.0)
        return dict(rank=state["rank"], acc=jnp.zeros(n, jnp.float32).at[dst].add(vals))

    eng = DistributedEngine(store, sched, edge_update, combine=dict(rank="max", acc="add"))
    state = dict(rank=jnp.full((n,), 1.0 / n), acc=jnp.zeros(n))
    dangling = jnp.asarray(np.diff(store.indptr) == 0)
    for _ in range(20):
        state = eng.step(state)
        dm = jnp.sum(jnp.where(dangling, state["rank"], 0.0))
        state = dict(rank=0.15 / n + 0.85 * (state["acc"] + dm / n), acc=jnp.zeros(n))
    out["distributed_pagerank"] = np.asarray(state["rank"]).tolist()
    print("REF8", json.dumps(out))
"""

#: name → ((scale, edge factor, seed), p, budget, plan kwargs): ≥ 2 waves
#: of 8 shards for all but TC, dense tiles per shard for PageRank, BFS, TC
REF8_CASES = {
    "pagerank": ((9, 8, 5), 8, "64KB", dict(mode="hybrid", dense_density=0.001, tile_dim=64)),
    "sv": ((9, 8, 5), 8, "6KB", SPARSE),
    "afforest": ((9, 8, 5), 8, "6KB", SPARSE),
    "bfs": ((9, 8, 5), 8, "64KB", dict(mode="hybrid", dense_density=0.001, tile_dim=64,
                                        direction="auto")),
    "kcore3": ((9, 8, 5), 8, "6KB", SPARSE),
    "hits": ((9, 8, 5), 8, "6KB", SPARSE),
    "tc": ((8, 8, 3), 4, "200KB", HYBRID),
}
PORT_FACTORIES = dict(pagerank=pa.pagerank_algorithm, sv=pa.sv_algorithm,
                      afforest=pa.afforest_algorithm, bfs=lambda: pa.bfs_algorithm(0),
                      kcore3=lambda: pa.kcore_algorithm(3),
                      hits=lambda: pa.hits_algorithm(tol=-1.0, max_iters=20),
                      tc=pa.tc_algorithm)


@pytest.fixture(scope="module")
def reference8():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF8), json.dumps(REF8_CASES)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert "REF8" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.split("REF8", 1)[1])


@pytest.mark.parametrize("name", sorted(REF8_CASES))
def test_eight_shards_match_reference_eight_devices(reference8, name):
    (scale, ef, seed), p, budget, kw = REF8_CASES[name]
    g = rmat(scale, ef, seed=seed)
    g = orient_dag(g) if name == "tc" else g
    # waves pinned on both sides: a rebalance re-packs them from measured
    # wave times, which a loaded host skews
    plan = compile_plan(PORT_FACTORIES[name](), build_block_store(g, p), share=False,
                        host_fraction=None, rebalance_threshold=None, memory_budget=budget,
                        mesh=_cpu_mesh(8), **kw)
    res = plan.run()
    st = res.schedule_stats["streaming"]
    want = reference8[name]
    assert res.iterations == want["iterations"]
    _same(res.result, want["result"])
    for key in ("num_waves", "bytes_per_wave", "per_device_bytes"):
        assert st[key] == want[key], key
    assert [bool(s.run_dense) for s in plan._slabs] == want["dense"]
    # the task lists each shard was staged, as the executor split them
    assert [[t.tolist() for t in s.shard_tasks] for s in plan._slabs] == want["tasks"]
    if name == "tc":
        # the port counts triangles in int64, the reference in int32
        # (ROADMAP C): the same folds, twice the bytes
        assert st["collective_bytes"] == 2 * want["collective_bytes"]
    else:
        assert st["collective_bytes"] == want["collective_bytes"]
    if any(want["dense"]):
        assert st["mesh_devices"] == 8 and max(st["per_device_bytes"]) <= st["budget_bytes"]


def test_distributed_engine_pagerank_matches_reference_and_incore(reference8):
    store = build_block_store(rmat(9, 8, seed=3), 4)
    sched = build_schedule(pa.pagerank_algorithm(), store, num_devices=8, mode="sparse_only")
    inv_deg = torch.from_numpy(1.0 / np.maximum(np.diff(store.indptr), 1)).float()
    n = store.n

    def edge_update(src, dst, valid, state):
        contrib = state["rank"] * inv_deg.to(src.device)
        vals = torch.where(valid, contrib[src.long()], 0.0)
        acc = torch.zeros(n, dtype=torch.float32, device=src.device)
        return dict(rank=state["rank"], acc=acc.index_add_(0, dst.long(), vals))

    eng = DistributedEngine(store, sched, edge_update, combine=dict(rank="max", acc="add"),
                            mesh=_cpu_mesh(8))
    assert [int(v.sum()) for v in eng.valid] == [int(x) for x in
                                                 make_device_edge_partition(store, sched)["edges"]]
    state = dict(rank=torch.full((n,), 1.0 / n), acc=torch.zeros(n))
    dangling = torch.from_numpy(np.diff(store.indptr) == 0)
    for _ in range(20):
        state = eng.step(state)
        dm = torch.where(dangling, state["rank"], 0.0).sum()
        state = dict(rank=0.15 / n + 0.85 * (state["acc"] + dm / n), acc=torch.zeros(n))
    got = state["rank"].numpy()
    want = pa.pagerank(build_block_store(rmat(9, 8, seed=3), 4), device="cpu",
                       mode="sparse_only")
    assert float(np.abs(got - want).max()) < 1e-5
    np.testing.assert_allclose(got, reference8["distributed_pagerank"], **TOL)
    with pytest.raises(ValueError, match="8 devices"):
        DistributedEngine(store, sched, edge_update, mesh=_cpu_mesh(4))
