"""The port's run checkpoints on the CPU, against the JAX package.

A run snapshot taken at any iteration boundary and resumed on a freshly
compiled plan gives the uninterrupted run's final state: bit for bit
for BFS (auto), SV and k-core, in-core and streamed; PageRank within
rtol 1e-5 / atol 1e-7 (float32 sums in another order).  The on-disk
format is the reference package's, so a snapshot written by either
package resumes in the other to the writer's final state.
"""
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

import repro.algorithms as ra
import repro.core as rc
from repro.checkpoint import runstate as r_runstate

import repro_torch.algorithms as pa
from repro_torch.checkpoint import (
    CheckpointManager, latest_runstate_step, latest_step, load_runstate, restore_checkpoint,
    save_checkpoint, save_runstate,
)
from repro_torch.core import InjectedFault, RetryPolicy, compile_plan

from test_torch_algorithms import _carry

BUDGET = "32KB"   # rmat(9) at p=8: 5 waves

ALGS = {
    "bfs_auto": (lambda: ra.bfs_algorithm(0), lambda: pa.bfs_algorithm(0), "auto"),
    "sv": (ra.sv_algorithm, pa.sv_algorithm, None),
    "kcore": (lambda: ra.kcore_algorithm(3), lambda: pa.kcore_algorithm(3), None),
    "pagerank": (lambda: ra.pagerank_algorithm(max_iters=5),
                 lambda: pa.pagerank_algorithm(max_iters=5), None),
}

_STORES: dict = {}


def _stores():
    if not _STORES:
        sr = rc.build_block_store(rc.rmat(9, 8, seed=3), 8)
        _STORES["s"] = (sr, _carry(sr))
    return _STORES["s"]


def _plan(name, streamed, *, ref=False, **kw):
    r_alg, p_alg, direction = ALGS[name]
    sr, sp = _stores()
    kw = dict(kw, mode="sparse_only", share=False, direction=direction)
    if streamed:
        kw.update(memory_budget=BUDGET, rebalance_threshold=None, host_fraction=None)
    if ref:
        return rc.compile_plan(r_alg(), sr, backend="xla", **kw)
    return compile_plan(p_alg(), sp, device="cpu", **kw)


def _steps(d):
    out = []
    for fn in glob.glob(os.path.join(d, "step_*.npz")):
        m = re.fullmatch(r"step_(\d+)\.npz", os.path.basename(fn))
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _assert_same(a, b):
    if isinstance(a, dict) or isinstance(b, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("streamed", [False, True], ids=["incore", "streamed"])
@pytest.mark.parametrize("name", sorted(ALGS))
def test_resume_every_boundary(name, streamed, tmp_path):
    base = _plan(name, streamed).run()
    if streamed:
        assert base.schedule_stats["streaming"]["num_waves"] >= 4
    d = str(tmp_path / "ck")
    ck = _plan(name, streamed, checkpoint_every=1, checkpoint_dir=d).run()
    _assert_same(ck.result, base.result)
    assert ck.schedule_stats["resilience"]["checkpoints"] == ck.iterations
    steps = _steps(d)
    assert steps == list(range(1, ck.iterations + 1))
    fresh = _plan(name, streamed)       # the resuming plan writes no snapshot
    for s in steps:
        res = fresh.resume(d, step=s)
        assert res.iterations == base.iterations
        _assert_same(res.result, base.result)
        if name == "bfs_auto":
            assert (res.schedule_stats["direction"]["decisions"]
                    == base.schedule_stats["direction"]["decisions"])


def test_checkpoint_every_two_matches_reference(tmp_path):
    """Snapshots land every second boundary and where ``after`` stops
    the loop; an iteration cap alone writes none."""
    for name in ("pagerank", "bfs_auto"):
        dp, dr = str(tmp_path / f"p{name}"), str(tmp_path / f"r{name}")
        res = _plan(name, False, checkpoint_every=2, checkpoint_dir=dp).run()
        _plan(name, False, ref=True, checkpoint_every=2, checkpoint_dir=dr).run()
        steps = _steps(dp)
        assert steps == _steps(dr)
        assert steps and all(s % 2 == 0 or s == res.iterations for s in steps)


def test_snapshot_roundtrip_dtypes(tmp_path):
    """Every leaf comes back in the init_state template's dtype."""
    d = str(tmp_path / "ck")
    plan = _plan("sv", True, checkpoint_every=1, checkpoint_dir=d)
    plan.run()
    template = plan.alg.init_state(plan.store)
    snap = load_runstate(d, template, step=1)
    assert snap.it == 1 and snap.step == 1 and snap.ctrl is None
    for k, leaf in template.items():
        assert np.asarray(snap.state[k]).dtype == np.asarray(leaf).dtype


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64, torch.float32,
                                   torch.bfloat16])
def test_tensor_leaves_roundtrip_bit_for_bit(dtype, tmp_path):
    g = torch.Generator().manual_seed(0)
    raw = torch.randint(-2**31, 2**31 - 1, (7, 3), generator=g, dtype=torch.int64)
    if dtype == torch.bool:
        x = raw % 2 == 0
    elif dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((7, 3), generator=g).to(dtype)
        x[0, 0] = float("inf")
        x[0, 1] = -0.0
    else:
        x = (raw if dtype == torch.int64 else raw.to(torch.int32)) * 3
    tree = dict(a=x, b=[x[0], (x[1:3],)], c=np.int64(2**40), d=None)
    save_checkpoint(str(tmp_path), 4, tree)
    got, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 4 and got["d"] is None
    for a, b in ((got["a"], x), (got["b"][0], x[0]), (got["b"][1][0], x[1:3])):
        assert a.dtype == dtype and torch.equal(a, b)
    assert got["c"].dtype == np.int64 and int(got["c"]) == 2**40
    got, _ = restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert isinstance(got["c"], torch.Tensor) and int(got["c"]) == 2**40


def test_latest_pointer_and_torn_writes(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        save_checkpoint(d, s, dict(x=np.full(4, s, np.int32)))
    assert latest_step(d) == 3 and latest_runstate_step(d) == 3
    meta = json.load(open(os.path.join(d, "LATEST")))
    assert meta["file"] == "step_00000003.npz" and len(meta["sha256"]) == 64
    # a write that died before its os.replace leaves only a temp file
    with open(os.path.join(d, "step_00000004.npz.tmp.npz"), "wb") as f:
        f.write(b"PK\x03\x04torn")
    assert latest_step(d) == 3
    # a torn pointer falls back to the newest step on disk
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write('{"step": 3, "fi')
    assert latest_step(d) == 3
    # a pointer whose payload does not hash falls back too
    with open(os.path.join(d, "LATEST"), "w") as f:
        json.dump(dict(step=2, file="step_00000002.npz", sha256="0" * 64), f)
    assert latest_step(d) == 3
    os.remove(os.path.join(d, "step_00000003.npz"))
    assert latest_step(d) == 2
    got, step = restore_checkpoint(d, dict(x=np.zeros(4, np.int32)))
    assert step == 2 and (got["x"] == 2).all()
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), dict(x=np.zeros(1)))


def test_restore_into_a_template_of_dtypes(tmp_path):
    """A template whose leaves are torch dtypes alone: tensors of them on
    the host, or on ``device``; a 0-d leaf stays 0-d; the values exact."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4) / 8
    save_checkpoint(str(tmp_path), 0, dict(w=w, count=np.asarray(7, np.int32)))
    for device in (None, "cpu"):
        got, _ = restore_checkpoint(str(tmp_path), dict(w=torch.bfloat16, count=torch.int32),
                                    device=device)
        assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"].float(),
                                                                 torch.from_numpy(w))
        assert got["count"].dtype == torch.int32 and got["count"].shape == ()
        assert int(got["count"]) == 7


def test_checkpoint_manager_keeps_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=5)
    assert mgr.restore_or_init(lambda: dict(w=torch.zeros(3)))[1] == 0
    for step in range(0, 21):
        mgr.maybe_save(step, dict(w=torch.full((3,), float(step))))
    assert _steps(str(tmp_path)) == [15, 20]
    state, start = mgr.restore_or_init(lambda: dict(w=torch.zeros(3)), device="cpu")
    assert start == 21 and torch.equal(state["w"], torch.full((3,), 20.0))


def test_crash_then_resume(tmp_path):
    """A fault that exhausts max_retries escapes mid-run; the last
    boundary on disk resumes to the fault-free answer."""
    base = _plan("pagerank", False).run()
    d = str(tmp_path / "ck")
    doomed = _plan("pagerank", False, faults="wave.compute:raise:at(3)",
                   retry_policy=RetryPolicy(max_retries=0), checkpoint_every=1,
                   checkpoint_dir=d)
    with pytest.raises(InjectedFault):
        doomed.run()
    assert latest_runstate_step(d) == 3
    _assert_same(_plan("pagerank", False).resume(d).result, base.result)


def test_checkpoint_and_resume_validation():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _plan("sv", False, checkpoint_every=2)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _plan("sv", True, checkpoint_every=0, checkpoint_dir="unused")
    with pytest.raises(ValueError, match="checkpoint"):
        _plan("sv", False).resume()
    with pytest.raises(ValueError, match="checkpoint"):
        _plan("sv", True).resume()


@pytest.mark.parametrize("spec", ["stage.device_put:raise:at(1)", "stage.assemble:raise:at(2)",
                                  "wave.compute:oom:at(1)"])
def test_recovered_run_checkpoints_match(spec, tmp_path):
    base = _plan("sv", True).run()
    d = str(tmp_path / "ck")
    res = _plan("sv", True, faults=spec, checkpoint_every=1, checkpoint_dir=d).run()
    _assert_same(res.result, base.result)
    r = res.schedule_stats["resilience"]
    assert r["injected"] >= 1 and r["checkpoints"] >= 1
    fresh = _plan("sv", True)
    for s in _steps(d):
        _assert_same(fresh.resume(d, step=s).result, base.result)


# ------------------------------------------- state carried across packages
@pytest.mark.parametrize("streamed", [False, True], ids=["incore", "streamed"])
@pytest.mark.parametrize("name", ["bfs_auto", "kcore", "pagerank"])
def test_reference_snapshot_resumes_in_the_port(name, streamed, tmp_path):
    d = str(tmp_path / "ref")
    want = _plan(name, streamed, ref=True, checkpoint_every=1, checkpoint_dir=d).run()
    steps = _steps(d)
    assert len(steps) >= 2
    port = _plan(name, streamed)
    for s in (steps[0], steps[len(steps) // 2]):
        got = port.resume(d, step=s)
        assert got.iterations == want.iterations
        _assert_same(got.result, want.result)
        if name == "bfs_auto":
            assert (got.schedule_stats["direction"]["decisions"]
                    == want.schedule_stats["direction"]["decisions"])


@pytest.mark.parametrize("streamed", [False, True], ids=["incore", "streamed"])
@pytest.mark.parametrize("name", ["bfs_auto", "sv", "pagerank"])
def test_port_snapshot_resumes_in_the_reference(name, streamed, tmp_path):
    d = str(tmp_path / "port")
    want = _plan(name, streamed, checkpoint_every=1, checkpoint_dir=d).run()
    steps = _steps(d)
    assert len(steps) >= 2
    snap = r_runstate.load_runstate(d, ALGS[name][0]().init_state(_stores()[0]),
                                    step=steps[0])
    assert snap.it == steps[0] and (snap.ctrl is not None) == (name == "bfs_auto")
    ref = _plan(name, streamed, ref=True)
    got = ref.resume(d, step=steps[len(steps) // 2])
    assert got.iterations == want.iterations
    _assert_same(got.result, want.result)


def test_runstate_meta_is_the_reference_layout(tmp_path):
    """The keys and dtypes of a port snapshot are those of a reference
    snapshot of the same boundary."""
    sr, sp = _stores()
    state = pa.sv_algorithm().init_state(sp)
    save_runstate(str(tmp_path / "p"), state, it=2, cont=True)
    r_runstate.save_runstate(str(tmp_path / "r"), ra.sv_algorithm().init_state(sr),
                             it=2, cont=True)
    with np.load(str(tmp_path / "p" / "step_00000002.npz")) as zp, \
            np.load(str(tmp_path / "r" / "step_00000002.npz")) as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for k in zr.files:
            assert zp[k].dtype == zr[k].dtype and zp[k].shape == zr[k].shape
            np.testing.assert_array_equal(zp[k], zr[k])
