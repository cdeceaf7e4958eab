"""The port's heterogeneous host lane on the CPU, against the JAX package.

The same store (carried across with ``repro_torch.interop``) and the
same budget go through both packages at each host share.  The port's
device waves and host units must hold the reference's task lists, and
its ``schedule_stats["hetero"]`` the reference's keys and resolved
split.  Integer and bool results must equal the reference's and the
port's device-only run bit for bit; PageRank and HITS sum float32
partials in another order and agree to rtol 1e-5 / atol 1e-6 (the
reference's hetero tolerance).

``"auto"`` activates only once the calibration pass measures device
waves above ``REPRO_HETERO_NOISE_FLOOR_S``; where a test expects it to
peel nothing, the floor is pinned high on both packages' plans, so a
slow CPU wave cannot cross it.  Rebalancing (which re-packs on
measured wave times) is off, so that the task lists stay comparable.
"""
import os
import threading

import numpy as np
import pytest

import repro.algorithms as ra
import repro.core as rc

import repro_torch.algorithms as pa
from repro_torch.core import compile_plan
from repro_torch.core import stream as stream_mod
from repro_torch.kernels import ref as kref, registry

from test_torch_algorithms import _carry

#: (reference factory, port factory, budget) — tests/test_hetero.py's table
ALGS = {
    "pagerank": (ra.pagerank_algorithm, pa.pagerank_algorithm, "64KB"),
    "afforest": (ra.afforest_algorithm, pa.afforest_algorithm, "64KB"),
    "tc": (ra.tc_algorithm, pa.tc_algorithm, "256KB"),
    "bfs": (lambda: ra.bfs_algorithm(0), lambda: pa.bfs_algorithm(0), "64KB"),
    "sv": (ra.sv_algorithm, pa.sv_algorithm, "64KB"),
    "kcore": (lambda: ra.kcore_algorithm(3), lambda: pa.kcore_algorithm(3), "64KB"),
    # 20 iterations: HITS' default tol sits at the float32 noise floor,
    # where the two packages' sums stop at different counts (ROADMAP C)
    "hits": (lambda: ra.hits_algorithm(max_iters=20),
             lambda: pa.hits_algorithm(max_iters=20), "64KB"),
}
FRACTIONS = (0.0, 0.3, 1.0, "auto")
PIN_FLOOR = "1e9"       # seconds: no wave is that slow, so "auto" stays off

_STORES: dict = {}
_DEVICE_ONLY: dict = {}


def _stores(seed: int):
    """(reference store, port store) on the same arrays."""
    if seed not in _STORES:
        sr = rc.build_block_store(rc.rmat(9, 8, seed=seed), 4)
        _STORES[seed] = (sr, _carry(sr))
    return _STORES[seed]


def _plans(name, seed, frac):
    r_alg, p_alg, budget = ALGS[name]
    sr, sp = _stores(seed)
    # rebalancing re-packs on measured wave times: off, so the task
    # lists stay comparable after the runs
    kw = dict(mode="sparse_only", share=False, memory_budget=budget, host_fraction=frac,
              rebalance_threshold=None)
    ref = rc.compile_plan(r_alg(), sr, backend="xla", **kw)
    port = compile_plan(p_alg(), sp, device="cpu", **kw)
    return ref, port


def _device_only(name, seed):
    key = (name, seed)
    if key not in _DEVICE_ONLY:
        _, p_alg, budget = ALGS[name]
        plan = compile_plan(p_alg(), _stores(seed)[1], device="cpu", mode="sparse_only",
                            share=False, memory_budget=budget, host_fraction=None)
        _DEVICE_ONLY[key] = plan.run().result
    return _DEVICE_ONLY[key]


def _leaves(tree):
    if isinstance(tree, dict):
        return [np.asarray(tree[k]) for k in sorted(tree)]
    return [np.asarray(tree)]


def _assert_matches(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if b.dtype.kind in "biu":
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _assert_same_split(port, ref):
    assert port.num_waves == ref.num_waves
    for a, b in zip(port._slabs, ref._slabs):
        np.testing.assert_array_equal(a.wave.task_ids, b.wave.task_ids)
    assert len(port._host_units) == len(ref._host_units)
    for a, b in zip(port._host_units, ref._host_units):
        np.testing.assert_array_equal(a, b)


def _close(*plans):
    for p in plans:
        p.close()


@pytest.mark.parametrize("frac", FRACTIONS, ids=str)
@pytest.mark.parametrize("name", sorted(ALGS))
def test_hetero_matches_reference(name, frac, monkeypatch):
    if frac == "auto":
        monkeypatch.setenv("REPRO_HETERO_NOISE_FLOOR_S", PIN_FLOOR)
    ref, port = _plans(name, 3, frac)
    _assert_same_split(port, ref)
    want, got = ref.run(), port.run()
    _assert_same_split(port, ref)          # nothing re-planned during the runs
    assert got.iterations == want.iterations
    _assert_matches(got.result, want.result)
    _assert_matches(got.result, _device_only(name, 3))
    het, rhet = got.schedule_stats["hetero"], want.schedule_stats["hetero"]
    assert het.keys() == rhet.keys()
    for key in ("enabled", "host_fraction", "resolved_split", "host_tasks",
                "device_tasks", "host_units", "host_tasks_executed"):
        assert het[key] == rhet[key], key
    assert het["enabled"]                  # every ported algorithm is capable
    if frac in (0.0, "auto"):
        assert het["resolved_split"] == 0.0 and het["host_tasks"] == 0
    else:
        assert het["resolved_split"] > 0.0 and het["host_tasks_executed"] > 0
        assert het["makespan"]["host_s"] > 0.0
    st = got.schedule_stats["streaming"]
    assert all(b + w <= st["budget_bytes"]
               for b, w in zip(st["bytes_per_wave"], st["workspace_per_wave"]))
    _close(ref, port)


@pytest.mark.parametrize("name", sorted(ALGS))
def test_hetero_second_seed(name):
    ref, port = _plans(name, 11, 0.3)
    _assert_same_split(port, ref)
    got, want = port.run(), ref.run()
    _assert_matches(got.result, want.result)
    _assert_matches(got.result, _device_only(name, 11))
    assert got.schedule_stats["hetero"]["host_tasks"] > 0
    _close(ref, port)


def test_hetero_runs_the_kernels_plain_versions_on_the_host(monkeypatch):
    """Host units hold CPU tensors: a dense task peeled to the host runs
    the sparse formulation, and the tile kernels' wrappers are never
    handed a host unit's tensors."""
    seen = []
    real = stream_mod._HostLane._unit_context

    def spy(self, ids):
        ctx = real(self, ids)
        seen.append((ctx.device.type, ctx.tiles, bool(ctx.dense_edge_mask.any())))
        return ctx

    monkeypatch.setattr(stream_mod._HostLane, "_unit_context", spy)
    _, sp = _stores(3)
    plan = compile_plan(pa.pagerank_algorithm(), sp, device="cpu", mode="hybrid",
                        tile_dim=128, dense_density=0.001, share=False,
                        memory_budget="90KB", host_fraction=1.0)
    res = plan.run()
    assert seen and all(s == ("cpu", None, False) for s in seen)
    want = compile_plan(pa.pagerank_algorithm(), sp, device="cpu", mode="hybrid",
                        tile_dim=128, dense_density=0.001, share=False).run()
    np.testing.assert_allclose(res.result, want.result, rtol=1e-5, atol=1e-6)
    plan.close()


def test_host_pool_size_and_thread_names():
    _, sp = _stores(3)
    plan = compile_plan(pa.sv_algorithm(), sp, device="cpu", mode="sparse_only",
                        share=False, memory_budget="64KB", host_fraction=0.3)
    lane = plan._host_lane
    assert lane._pool._max_workers == min(len(plan._host_units),
                                          max(1, (os.cpu_count() or 2) - 1))
    name = lane._pool.submit(lambda: threading.current_thread().name).result()
    assert name.startswith("repro-host")
    plan.close()
    assert plan._host_lane is None


# ---------------------------------------------------------------- validation
def _validation_case(case):
    """(reference call, port call) raising the same exception type."""
    sr, sp = _stores(3)

    def both(r_alg, p_alg, **kw):
        return (lambda: rc.compile_plan(r_alg, sr, **kw),
                lambda: compile_plan(p_alg, sp, device="cpu", **kw))

    if case == "share_without_budget":
        return both(ra.sv_algorithm(), pa.sv_algorithm(), host_fraction=0.5)
    if case in ("1.5", "sometimes"):
        frac = 1.5 if case == "1.5" else "sometimes"
        return both(ra.sv_algorithm(), pa.sv_algorithm(), memory_budget="64KB",
                    host_fraction=frac)
    if case == "host_never":
        r, p = ra.sv_algorithm(), pa.sv_algorithm()
        r.metadata = dict(r.metadata, host="never")
        p.metadata = dict(p.metadata, host="never")
        return both(r, p, memory_budget="64KB", host_fraction=0.3)
    if case == "host_bogus":
        r, p = ra.sv_algorithm(), pa.sv_algorithm()
        r.metadata = dict(r.metadata, host="sometimes")
        p.metadata = dict(p.metadata, host="sometimes")
        return both(r, p, memory_budget="64KB", host_fraction=0.3)
    r, p = ra.sv_algorithm(), pa.sv_algorithm()
    r.metadata = dict(r.metadata, host_kernels=("not_a_real_kernel",))
    p.metadata = dict(p.metadata, host_kernels=("not_a_real_kernel",))
    return both(r, p, memory_budget="64KB", host_fraction=0.3)


@pytest.mark.parametrize("case", ["share_without_budget", "1.5", "sometimes",
                                  "host_never", "host_bogus", "uncertified_kernel"])
def test_validation_matches_reference(case):
    r_call, p_call = _validation_case(case)
    with pytest.raises(Exception) as r_err:
        r_call()
    with pytest.raises(Exception) as p_err:
        p_call()
    assert type(p_err.value) is type(r_err.value) is ValueError
    if case != "share_without_budget":
        assert ("host" in str(p_err.value)) == ("host" in str(r_err.value))


def test_host_never_keeps_auto_device_only():
    _, sp = _stores(3)
    alg = pa.sv_algorithm()
    alg.metadata = dict(alg.metadata, host="never")
    plan = compile_plan(alg, sp, device="cpu", mode="sparse_only", share=False,
                        memory_budget="64KB", host_fraction="auto")
    assert not plan._host_capable
    assert not plan.run().schedule_stats["hetero"]["enabled"]


def test_host_executable_certificate_matches_reference():
    from repro.kernels import ref as r_ref
    from repro.kernels import registry as r_registry

    assert kref.HOST_EXECUTABLE == r_ref.HOST_EXECUTABLE
    assert registry.registered_host_executable() == r_registry.registered_host_executable()
    assert all(registry.host_executable(k) for k in kref.HOST_EXECUTABLE)
    assert not registry.host_executable("flash_attention")
    registry.register_host_executable("flash_attention")
    try:
        assert registry.host_executable("flash_attention")
    finally:
        registry._HOST_OK.discard("flash_attention")


# ---------------------------------------------------------------- "auto"
def test_auto_activates_under_low_noise_floor(monkeypatch):
    """Lowering the noise floor makes the auto split probe the host on
    CPU-sized waves — and the result still equals the reference's."""
    monkeypatch.setenv("REPRO_HETERO_NOISE_FLOOR_S", "0.00001")
    ref, port = _plans("sv", 3, "auto")
    got = port.run()
    _assert_matches(got.result, ref.run().result)
    het = got.schedule_stats["hetero"]
    assert het["host_tasks_executed"] > 0
    assert het["host_ratio_measured"]
    assert het["refreshes"] >= 1
    _close(ref, port)


def _scripted_refresh(plan, wave_s, busy_s, it=0):
    plan._calibration = dict(wave_compute_s=list(wave_s))
    plan._last_host_busy_s = busy_s
    plan._maybe_refresh_split(it)


def test_refresh_split_hysteresis_matches_reference():
    """The same scripted calibrations drive both packages' auto split
    through activation (a probe per wave), a repeat inside the band
    (no re-plan), the noise floor and the last iteration (both stand
    down), and a measured host rate."""
    ref, port = _plans("pagerank", 3, "auto")
    nw = port.num_waves
    assert nw == ref.num_waves and nw >= 2
    floor = stream_mod._hetero_noise_floor_s()
    steps = [
        ([floor / 10] * nw, 0.0, 0),        # below the noise floor: nothing
        ([0.05] * nw, 0.0, 0),              # activation: probe tasks peeled
        (None, 0.0, 0),                     # same split proposed: no re-plan
        (None, 0.0, 10**6),                 # no later iteration: nothing
        (None, 0.01, 0),                    # host rate measured
    ]
    for wave_s, busy_s, it in steps:
        for plan in (ref, port):
            ws = wave_s if wave_s is not None else [0.05] * plan.num_waves
            _scripted_refresh(plan, ws, busy_s, it)
        _assert_same_split(port, ref)
        assert port._hetero_refreshes == ref._hetero_refreshes
        assert port._host_measured == ref._host_measured
        assert port._host_ratio == pytest.approx(ref._host_ratio, rel=1e-12)
    assert port._hetero_refreshes >= 1 and port._host_units
    # a repeat of an applied proposal stays inside the band
    before = port._hetero_refreshes
    _scripted_refresh(port, [0.05] * port.num_waves, port._last_host_busy_s)
    assert port._hetero_refreshes in (before, before + 1)
    want = ref.run().result
    got = port.run().result
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _close(ref, port)


def test_rebalance_keeps_the_host_split():
    """A re-pack of the device waves re-peels the host partition, and the
    reference does the same on the same observed times."""
    ref, port = _plans("pagerank", 3, 0.3)
    for plan in (ref, port):
        plan.rebalance_threshold = 1.5
        nw = plan.num_waves
        assert plan.rebalance([1.0] * (nw - 1) + [10.0 * nw])
    _assert_same_split(port, ref)
    assert port._host_units
    np.testing.assert_allclose(port.run().result, ref.run().result, rtol=1e-5, atol=1e-6)
    _close(ref, port)
