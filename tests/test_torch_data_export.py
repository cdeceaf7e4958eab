"""The port's graph benchmark suite and its trace and run-report exporters,
against the JAX package in one interpreter.

* ``benchmark_suite``: every graph's name, n, ``indptr`` and ``indices``
  equal the reference's at ``"small"`` and ``"bench"``;
* the exporters on one hand-built list of spans (a ``devices=3``
  device-lane span, a staging span, nested spans, arguments the export
  keeps and drops): the Chrome trace equal as JSON, the validator's
  failures the same ``ValueError``s, the run report equal;
* a traced streamed PageRank in each package: equal span counts per
  (name, lane, parent, wave), and the same lanes and phases in the
  exported trace;
* the port's 8-shard CPU mesh: one trace lane per shard and
  ``collective`` spans mirrored onto all 8.

Everything here is exact: host arrays, JSON objects and counts.
"""
import collections
import json
import sys

import numpy as np
import pytest
import torch

import repro.core as rc
from repro import obs as robs
from repro.algorithms import pagerank_algorithm as r_pagerank
from repro.data import benchmark_suite as r_benchmark_suite

import repro_torch.core as tc
from repro_torch import obs
from repro_torch.algorithms import pagerank_algorithm
from repro_torch.core import DeviceMesh
from repro_torch.data import benchmark_suite


# --------------------------------------------------------------- suite
@pytest.mark.parametrize("scale", ["small", "bench"])
def test_benchmark_suite_matches_reference(scale):
    want, got = r_benchmark_suite(scale), benchmark_suite(scale)
    assert list(got) == list(want)
    for key, gr in want.items():
        gt = got[key]
        assert (gt.name, gt.n, gt.m, gt.directed) == (gr.name, gr.n, gr.m, gr.directed), key
        for arr in ("indptr", "indices"):
            a, b = np.asarray(getattr(gr, arr)), getattr(gt, arr)
            assert a.dtype == b.dtype, (key, arr)
            np.testing.assert_array_equal(a, b, err_msg=f"{key}.{arr}")
    assert got["synthA"].name == "myciel-ish"


# ------------------------------------------------------------ exporters
def _spans(mod):
    """One hand-built span list in ``mod``'s SpanEvent type: a device-lane
    span over 3 devices, a staging span, a nested main-thread pair, and
    arguments the export keeps (Python scalars, a numpy float64, which is a
    float) and drops (a numpy int64, a list, a 0-d tensor)."""
    ev = mod.SpanEvent
    return [
        ev("iteration", 1_000, 90_000, "main", 0, None, dict(it=0)),
        ev("assemble", 2_500, 10_000, "staging", 0, None,
           dict(wave=0, nbytes=np.int64(4096), ratio=np.float64(0.5))),
        ev("compute", 14_000, 20_000, "device", 1, "iteration",
           dict(wave=0, devices=3, note="x", ok=True, none=None)),
        ev("device_put", 12_000, 1_500, "device", 1, "iteration", dict(wave=0)),
        ev("inner", 40_000, 5_000, "main", 2, "compute",
           dict(shape=[2, 3], zero_d=torch.tensor(1.0), scale=2.5)),
        ev("host_unit", 41_000, 2_000, "repro-host_0", 0, None, dict(tasks=4)),
    ]


def test_chrome_trace_matches_reference():
    want = robs.export.chrome_trace(_spans(robs))
    got = obs.export.chrome_trace(_spans(obs))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    info = obs.export.validate_chrome_trace(
        json.dumps(got), require_lanes=("main", "staging", "device/0", "device/1", "device/2"),
        require_phases=("compute", "assemble", "inner"))
    assert info == robs.export.validate_chrome_trace(json.dumps(want))
    assert info["span_counts"]["compute"] == 3      # mirrored onto every device
    lanes = [e["args"]["name"] for e in got["traceEvents"] if e["name"] == "thread_name"]
    assert lanes == ["main", "staging", "device/0", "device/1", "device/2", "repro-host_0"]
    args = {e["name"]: e["args"] for e in got["traceEvents"] if e["ph"] == "X"}
    assert args["assemble"] == dict(wave=0, ratio=0.5)
    assert args["inner"] == dict(scale=2.5, parent="compute")


def test_write_chrome_trace_round_trips(tmp_path):
    path = tmp_path / "trace.json"
    obj = obs.export.write_chrome_trace(str(path), _spans(obs))
    assert json.loads(path.read_text()) == obj


def test_chrome_trace_needs_events_or_tracing(monkeypatch):
    # the package's name ``tracer`` is the function; the module holds the state
    monkeypatch.setattr(sys.modules["repro_torch.obs.tracer"], "_tracer", None)
    with pytest.raises(RuntimeError, match="tracing is disabled"):
        obs.export.chrome_trace()


def _bad_ts():
    return dict(traceEvents=[
        dict(ph="X", pid=1, tid=1, name="a", ts=100.0, dur=1.0, args={}),
        dict(ph="X", pid=1, tid=1, name="b", ts=50.0, dur=1.0, args={}),
    ])


def _neg_dur():
    return dict(traceEvents=[dict(ph="X", pid=1, tid=1, name="a", ts=1.0, dur=-2.0, args={})])


@pytest.mark.parametrize("obj,kw", [
    ({}, {}),
    (_bad_ts(), {}),
    (_neg_dur(), {}),
    (dict(traceEvents=[]), dict(require_lanes=("staging",))),
    (dict(traceEvents=[]), dict(require_phases=("compute",))),
    (dict(traceEvents=[dict(ph="B", name="a")]), {}),
], ids=["no_events", "non_monotonic", "negative_dur", "lane_missing", "phase_missing",
        "bad_phase"])
def test_validate_chrome_trace_fails_as_reference(obj, kw):
    with pytest.raises(ValueError) as want:
        robs.export.validate_chrome_trace(obj, **kw)
    with pytest.raises(ValueError) as got:
        obs.export.validate_chrome_trace(obj, **kw)
    assert str(got.value) == str(want.value)


def test_run_report_matches_reference():
    payload = dict(checks=dict(ok=True), passed=True, floors=dict(x=0.5))
    got = obs.export.run_report("unit_test", dict(payload), include_metrics=False)
    assert got == robs.export.run_report("unit_test", dict(payload), include_metrics=False)
    assert (got["schema"], got["schema_version"]) == ("repro.obs.run_report", 1)
    assert isinstance(obs.export.run_report("unit_test", dict(payload))["metrics"], dict)
    for key in ("schema", "schema_version", "report"):
        with pytest.raises(ValueError, match="collide"):
            obs.export.run_report("x", {key: "boom"})


# ------------------------------------------------------- traced runs
def _span_counts(events):
    return collections.Counter((e.name, e.lane, e.parent, e.args.get("wave")) for e in events)


def test_streamed_trace_matches_reference():
    """rmat(8, 8, seed=3), p=4, sparse_only, a 16KB budget, synchronous
    staging, 3 iterations: the reference's span tree, counted span by span.
    No host lane: under "auto" it peels by measured wave times, which follow
    the host's load."""
    kw = dict(mode="sparse_only", share=False, memory_budget="16KB", pipeline_depth=0,
              rebalance_threshold=None, host_fraction=None)
    rplan = rc.compile_plan(r_pagerank(max_iters=3, tol=0.0),
                            rc.build_block_store(rc.rmat(8, 8, seed=3), 4), **kw)
    plan = tc.compile_plan(pagerank_algorithm(max_iters=3, tol=0.0),
                           tc.build_block_store(tc.rmat(8, 8, seed=3), 4), device="cpu", **kw)
    with robs.tracing() as tr:
        rres = rplan.run()
        want = _span_counts(tr.events())
        robj = robs.export.chrome_trace()
    with obs.tracing() as tr:
        res = plan.run()
        events = tr.events()
        obj = obs.export.chrome_trace()
    assert _span_counts(events) == want
    waves = res.schedule_stats["streaming"]["num_waves"]
    assert waves == rres.schedule_stats["streaming"]["num_waves"] >= 4
    for name in ("assemble", "device_put", "compute"):
        assert {e.args["wave"] for e in events if e.name == name} == set(range(waves))
    phases = ("assemble", "device_put", "compute", "iteration")
    info = obs.export.validate_chrome_trace(obj, require_lanes=("main", "staging", "device/0"),
                                            require_phases=phases)
    rinfo = robs.export.validate_chrome_trace(robj)
    assert info["lanes"] == rinfo["lanes"] == ["device/0", "main", "staging"]
    assert info["span_counts"] == rinfo["span_counts"]
    np.testing.assert_allclose(res.result, np.asarray(rres.result), rtol=1e-5, atol=1e-7)


def test_mesh_trace_has_a_lane_per_shard():
    """The reference needs an 8-device XLA host platform in a subprocess for
    this (tests/test_obs.py); the port's CPU mesh runs in this process."""
    plan = tc.compile_plan(pagerank_algorithm(max_iters=3, tol=0.0),
                           tc.build_block_store(tc.rmat(10, 16, seed=5), 8), mode="sparse_only",
                           share=False, memory_budget="12KB", mesh=DeviceMesh(["cpu"] * 8),
                           rebalance_threshold=None, host_fraction=None)
    with obs.tracing() as tr:
        res = plan.run()
        events = tr.events()
        obj = obs.export.chrome_trace()
    waves = res.schedule_stats["streaming"]["num_waves"]
    assert waves >= 4
    lanes = ["main", "staging"] + [f"device/{i}" for i in range(8)]
    info = obs.export.validate_chrome_trace(
        obj, require_lanes=lanes,
        require_phases=("assemble", "device_put", "compute", "collective", "iteration"))
    assert set(info["lanes"]) == set(lanes)
    for name in ("assemble", "device_put", "compute", "collective"):
        assert sorted({e.args["wave"] for e in events if e.name == name}) == list(range(waves))
    assert all(e.args["devices"] == 8 and type(e.args["devices"]) is int
               for e in events if e.lane == "device")
    assert info["span_counts"]["collective"] % 8 == 0
    assert info["span_counts"]["collective"] == 8 * sum(e.name == "collective" for e in events)
