"""The port's fault injection and recovery ladder on the CPU, against the
JAX package.

Fault specs parse to the same rules (or fail with the same exception
type), fire in the same sequence, and a seeded fault at each executor
seam is recovered to the fault-free result — bit for bit for integer
and bool attributes, within rtol 1e-6 / atol 1e-7 for PageRank (the
reference resilience tests' tolerance) — with the same resilience
counters as the reference on the same spec and plan.  Where a recovery
depends on which thread fails first (the staging worker, the host
pool), the port is held to the reference tests' own assertions.
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro.algorithms as ra
import repro.core as rc
from repro.core import faults as r_faults
from repro.core import resilience as r_resil

import repro_torch.algorithms as pa
from repro_torch.core import compile_plan
from repro_torch.core.faults import SITES, FaultPlan, InjectedFault, InjectedOOM, _corrupt
from repro_torch.core.resilience import (
    HostTaskError, RetryPolicy, WorkerDeath, classify, is_oom,
)

from test_torch_algorithms import _carry

BUDGET = "32KB"   # rmat(9) at p=8: 5 waves
COUNTERS = ("injected", "detected", "retries", "demotions", "failovers",
            "host_failovers", "oom_repacks", "checkpoints")

_STORES: dict = {}


def _stores():
    if not _STORES:
        sr = rc.build_block_store(rc.rmat(9, 8, seed=3), 8)
        _STORES["s"] = (sr, _carry(sr))
    return _STORES["s"]


def _streamed(name, *, faults=None, policy=None, depth=None, host=None, ref=False):
    """The reference's (``ref=True``) or the port's streamed plan of the
    reference resilience tests: sparse_only, 32KB, no rebalancing."""
    r_alg, p_alg = dict(
        pagerank=(lambda: ra.pagerank_algorithm(max_iters=6),
                  lambda: pa.pagerank_algorithm(max_iters=6)),
        sv=(ra.sv_algorithm, pa.sv_algorithm))[name]
    sr, sp = _stores()
    kw = dict(mode="sparse_only", share=False, memory_budget=BUDGET,
              rebalance_threshold=None, host_fraction=host, faults=faults,
              **(dict(pipeline_depth=depth) if depth is not None else {}))
    if ref:
        r_policy = None
        if policy is not None:
            r_policy = r_resil.RetryPolicy(**{f: getattr(policy, f) for f in (
                "max_retries", "backoff", "demote_after", "failover_after")})
        return rc.compile_plan(r_alg(), sr, backend="xla", retry_policy=r_policy, **kw)
    return compile_plan(p_alg(), sp, device="cpu", retry_policy=policy, **kw)


_BASE: dict = {}


def _baseline(name):
    if name not in _BASE:
        _BASE[name] = _streamed(name).run().result
    return _BASE[name]


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "biu":
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _counters(stats):
    r = stats["resilience"]
    return {k: r[k] for k in COUNTERS}, [a["action"] for a in r["actions"]]


# ------------------------------------------------------------------ specs
SPECS = [
    "wave.compute:raise:at(2); host.task:delay(0.01):every(3)",
    "stage.assemble:raise:at(1);stage.device_put:oom:at(2);wave.compute:raise:at(1);"
    "host.task:raise:once",
    "wave.compute:corrupt:every(1)", "stage.device_put:delay(0.5)", "serve.query:oom",
    "mesh.collective:raise:once", "", " ; ",
    "wave.compute", "nowhere:raise", "wave.compute:explode", "wave.compute:raise:sometimes",
    "wave.compute:delay", "wave.compute:raise(2)", "wave.compute:raise:every(0)",
    "wave.compute:raise:at(-1)", "wave.compute:raise:once(3)", "a:b:c:d",
    "wave.compute:delay(x)",
]


def _rules(fp):
    if fp is None:
        return None
    return [(r.site, r.action, r.arg, r.trigger, r.k) for r in fp.rules]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_reference(spec):
    try:
        want = _rules(r_faults.FaultPlan.parse(spec))
    except Exception as e:
        with pytest.raises(type(e)) as err:
            FaultPlan.parse(spec)
        assert str(err.value) == str(e)
        return
    assert _rules(FaultPlan.parse(spec)) == want


def test_sites_and_passthrough():
    assert SITES == r_faults.SITES
    fp = FaultPlan.parse("wave.compute:raise")
    assert FaultPlan.parse(fp) is fp
    assert FaultPlan.parse(None) is None


def _script(fp, inject):
    """Fire a fixed sequence of sites; record what each call did."""
    out = []
    calls = [("stage.assemble", dict(wave=w)) for w in range(4)]
    calls += [("wave.compute", dict(wave=w % 3)) for w in range(9)]
    calls += [("host.task", dict(unit=u)) for u in range(5)]
    calls += [("stage.device_put", dict(wave=2)), ("stage.device_put", dict(wave=2))]
    for site, ctx in calls:
        try:
            v = fp.fire(site, 7, **ctx)
            out.append(("ok", int(np.asarray(v))))
        except inject as e:
            out.append((type(e).__name__, e.site, str(e)))
    return out, fp.stats()


def test_firing_sequence_matches_reference():
    spec = ("stage.assemble:raise:at(2);wave.compute:oom:every(4);"
            "wave.compute:corrupt:at(1);host.task:raise:once;stage.device_put:oom:at(2)")
    got = _script(FaultPlan.parse(spec), InjectedFault)
    want = _script(r_faults.FaultPlan.parse(spec), r_faults.InjectedFault)
    assert got == want
    fp = FaultPlan.parse(spec)
    _script(fp, InjectedFault)
    fp.reset()
    assert fp.injected == 0 and _script(fp, InjectedFault) == want


def test_corrupt_returns_a_damaged_copy():
    x = torch.arange(3, dtype=torch.int32)
    m = torch.tensor([True, False])
    f = torch.tensor([0.5])
    out = FaultPlan.parse("wave.compute:corrupt").fire(
        "wave.compute", dict(x=x, m=m, f=f, n=np.arange(2), s=None))
    assert torch.equal(out["x"], torch.tensor([1, 2, 3], dtype=torch.int32))
    assert torch.equal(out["m"], torch.tensor([False, True]))
    assert torch.equal(out["f"], torch.tensor([1.5]))
    np.testing.assert_array_equal(out["n"], [1, 2])
    assert out["s"] is None
    # the inputs are untouched
    assert torch.equal(x, torch.arange(3, dtype=torch.int32))
    assert torch.equal(m, torch.tensor([True, False]))
    want = r_faults._corrupt(dict(n=np.arange(2), b=np.array([True])))
    got = _corrupt(dict(n=np.arange(2), b=np.array([True])))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -------------------------------------------------------------- is_oom
def test_is_oom_classifies_torch_errors():
    real = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 160.00 GiB")
    assert is_oom(real) and classify(real) == "oom"
    assert not r_resil.is_oom(real)    # the reference matches names, and misses it
    plain = RuntimeError("CUDA out of memory. Tried to allocate 2.00 MiB")
    assert is_oom(plain) and classify(plain) == "oom"
    assert is_oom(MemoryError()) and is_oom(InjectedOOM("wave.compute", wave=1))
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: too many resources requested for launch",
                "CUDA error: no kernel image is available for execution on the device"):
        e = RuntimeError(msg)
        assert not is_oom(e) and classify(e) == "fault"
    wrapped = HostTaskError(0, [1], 0, RuntimeError("out of memory"))
    assert not is_oom(wrapped) and classify(wrapped) == "host"
    assert classify(WorkerDeath(MemoryError())) == "worker"
    assert classify(InjectedFault("stage.assemble")) == "fault"


def test_retry_policy_validation():
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff=1.0)
    sr, sp = _stores()
    with pytest.raises(TypeError):
        compile_plan(pa.pagerank_algorithm(), sp, device="cpu", retry_policy="aggressive")
    with pytest.raises(TypeError):
        compile_plan(pa.pagerank_algorithm(), sp, device="cpu", memory_budget=BUDGET,
                     retry_policy=r_resil.RetryPolicy())


def test_env_fault_spec_reaches_plan(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "wave.compute:raise:once")
    _, sp = _stores()
    res = compile_plan(pa.pagerank_algorithm(max_iters=3), sp, device="cpu",
                       share=False).run()
    r = res.schedule_stats["resilience"]
    assert r["injected"] == 1 and r["retries"] == 1


# ------------------------------------------------- recovery (streaming)
@pytest.mark.parametrize("spec", [
    "stage.assemble:raise:at(1)",
    "stage.device_put:raise:at(1)",
    "stage.device_put:oom:at(2)",
    "wave.compute:raise:at(1)",
    "wave.compute:raise:at(0)",
    "stage.device_put:delay(0.01):once",
])
def test_site_recovery_matches_reference(spec):
    port = _streamed("pagerank", faults=spec, depth=0)
    ref = _streamed("pagerank", faults=spec, depth=0, ref=True)
    got, want = port.run(), ref.run()
    _assert_same(got.result, _baseline("pagerank"))
    _assert_same(got.result, want.result)
    assert _counters(got.schedule_stats) == _counters(want.schedule_stats)
    assert got.schedule_stats["resilience"]["injected"] == 1


def test_oom_shrink_repack_matches_reference():
    port = _streamed("sv", faults="wave.compute:oom:at(1)", depth=0)
    ref = _streamed("sv", faults="wave.compute:oom:at(1)", depth=0, ref=True)
    got, want = port.run(), ref.run()
    _assert_same(got.result, _baseline("sv"))
    assert _counters(got.schedule_stats) == _counters(want.schedule_stats)
    r = got.schedule_stats["resilience"]
    assert r["oom_repacks"] == 1 and r["demotions"] == 0
    assert port.num_waves == ref.num_waves > 5
    for a, b in zip(port._slabs, ref._slabs):
        np.testing.assert_array_equal(a.wave.task_ids, b.wave.task_ids)
    assert all(s.staged_bytes + s.workspace_bytes <= port.budget.total_bytes
               for s in port._slabs)


def test_repeated_oom_demotes_to_host_matches_reference():
    spec = "wave.compute:oom:at(1);wave.compute:oom:at(1)"
    policy = RetryPolicy(max_retries=4, demote_after=2)
    port = _streamed("sv", faults=spec, policy=policy, depth=0)
    ref = _streamed("sv", faults=spec, policy=policy, depth=0, ref=True)
    got, want = port.run(), ref.run()
    _assert_same(got.result, _baseline("sv"))
    assert _counters(got.schedule_stats) == _counters(want.schedule_stats)
    r = got.schedule_stats["resilience"]
    assert r["demotions"] >= 1 and r["oom_repacks"] >= 1
    assert len(port._host_units) == len(ref._host_units) >= 1
    for a, b in zip(port._host_units, ref._host_units):
        np.testing.assert_array_equal(a, b)
    assert got.schedule_stats["hetero"]["host_tasks_executed"] > 0
    port.close()


def test_assemble_fault_during_calibration_recovers():
    res = _streamed("pagerank", faults="stage.assemble:raise:at(2)", depth=2).run()
    _assert_same(res.result, _baseline("pagerank"))
    assert res.schedule_stats["resilience"]["retries"] >= 1


def _kill_worker(plan, deaths: int):
    """Make assembly raise the next ``deaths`` times it runs OFF the
    main thread — inside the background staging worker — so that the
    failure surfaces as WorkerDeath."""
    orig = plan._assemble_runtime
    state = dict(deaths=0)

    def bomb(recipe, wave=None):
        if (threading.current_thread() is not threading.main_thread()
                and state["deaths"] < deaths):
            state["deaths"] += 1
            raise RuntimeError("simulated staging worker crash")
        return orig(recipe, wave=wave)

    plan._assemble_runtime = bomb
    return state


def test_worker_death_fails_over():
    plan = _streamed("pagerank", depth=2)
    killed = _kill_worker(plan, 1)
    res = plan.run()
    _assert_same(res.result, _baseline("pagerank"))
    assert killed["deaths"] == 1
    r = res.schedule_stats["resilience"]
    assert r["failovers"] == 1 and r["retries"] >= 1
    assert [a["action"] for a in r["actions"]] == ["failover_sync"]
    assert plan.pipeline_depth > 0       # transient: the pipeline survives


def test_permanent_worker_failover():
    plan = _streamed("pagerank", policy=RetryPolicy(failover_after=1), depth=2)
    killed = _kill_worker(plan, 5)
    res = plan.run()
    _assert_same(res.result, _baseline("pagerank"))
    assert killed["deaths"] == 1         # synchronous assembly never re-arms it
    assert plan.pipeline_depth == 0
    assert res.schedule_stats["resilience"]["failovers"] >= 1


def test_exhausted_retries_raise():
    plan = _streamed("pagerank", faults="wave.compute:raise:every(1)",
                     policy=RetryPolicy(max_retries=2), depth=0)
    with pytest.raises(InjectedFault):
        plan.run()
    assert plan._resil.actions[-1]["action"] == "exhausted"
    assert plan._resil.detected == 3 and plan._resil.retries == 2


def test_corrupt_is_detectable():
    """Silent corruption is not detected by the runtime: the
    differential check must be sensitive enough to catch it (the
    control for every checksum-exact test above)."""
    res = _streamed("pagerank", faults="wave.compute:corrupt:every(1)", depth=0).run()
    assert res.schedule_stats["resilience"]["injected"] >= 1
    assert not np.allclose(np.asarray(res.result), _baseline("pagerank"))


def test_disabled_keys_unchanged():
    res = _streamed("pagerank").run()
    assert "resilience" not in res.schedule_stats
    _, sp = _stores()
    res = compile_plan(pa.pagerank_algorithm(max_iters=3), sp, device="cpu",
                       share=False).run()
    assert "resilience" not in res.schedule_stats


# ------------------------------------------------------ host-lane blame
def test_host_fault_recovers_like_reference():
    port = _streamed("sv", faults="host.task:raise:once", host=0.25)
    ref = _streamed("sv", faults="host.task:raise:once", host=0.25, ref=True)
    got, want = port.run(), ref.run()
    _assert_same(got.result, _baseline("sv"))
    assert _counters(got.schedule_stats) == _counters(want.schedule_stats)
    assert got.schedule_stats["resilience"]["retries"] >= 1
    port.close()


def test_host_error_carries_context():
    plan = _streamed("sv", faults="host.task:raise:every(1)",
                     policy=RetryPolicy(max_retries=0), host=0.25)
    with pytest.raises(HostTaskError) as ei:
        plan.run()
    err = ei.value
    assert err.unit >= 0 and err.it >= 0
    assert "host-lane unit" in str(err) and "iteration" in str(err)
    assert isinstance(err.__cause__, InjectedFault)
    plan.close()


def test_repeated_host_failure_disables_lane_like_reference():
    spec, policy = "host.task:raise:every(1)", RetryPolicy(max_retries=6, failover_after=1)
    port = _streamed("sv", faults=spec, policy=policy, host=0.25)
    ref = _streamed("sv", faults=spec, policy=policy, host=0.25, ref=True)
    got, want = port.run(), ref.run()
    _assert_same(got.result, _baseline("sv"))
    assert (got.schedule_stats["resilience"]["host_failovers"]
            == want.schedule_stats["resilience"]["host_failovers"] >= 1)
    assert not port._host_units and port._host_lane is None
    assert got.schedule_stats["hetero"]["host_tasks"] == 0


# ----------------------------------------------------- teardown (close)
def test_close_and_context_manager():
    before = {t.ident for t in threading.enumerate()}
    plan = _streamed("sv", faults="wave.compute:raise:at(2)",
                     policy=RetryPolicy(max_retries=0), depth=2, host=0.25)
    with pytest.raises(InjectedFault):
        with plan:
            plan.run()
    deadline = time.time() + 10.0
    leaked = []
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t.ident not in before and t.is_alive() and not t.daemon]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"leaked threads: {leaked}"
    assert plan._pipe is None and plan._host_futs is None and plan._host_lane is None


def test_close_idempotent_and_rerunnable():
    plan = _streamed("sv", depth=2, host=0.25)
    res1 = plan.run()
    plan.close()
    plan.close()
    res2 = plan.run()   # run() rebuilds the lane and the pipe lazily
    _assert_same(res1.result, _baseline("sv"))
    _assert_same(res2.result, _baseline("sv"))
    plan.close()


# ------------------------------------------------------------- in-core
def test_incore_retry_matches_reference():
    sr, sp = _stores()
    spec = "wave.compute:raise:at(1);wave.compute:oom:at(3)"
    want = rc.compile_plan(ra.sv_algorithm(), sr, backend="xla", share=False,
                           faults=spec).run()
    got = compile_plan(pa.sv_algorithm(), sp, device="cpu", share=False, faults=spec).run()
    _assert_same(got.result, want.result)
    assert _counters(got.schedule_stats) == _counters(want.schedule_stats)
    assert got.schedule_stats["resilience"]["retries"] == 2
