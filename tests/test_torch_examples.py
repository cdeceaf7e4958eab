"""The port's examples and its one-shot API, on the CPU.

* Each graph example (``examples/torch_{quickstart,pipeline,
  heterogeneous_schedule}.py``) runs in a subprocess with ``--device cpu``
  beside its reference example; the printed lines agree number for number:
  integers (sizes, components, depths, triangles, the schedule table)
  exactly, floats (PageRank sums, ratios) within 1e-5.  Left out:
  ``compile_count`` (the reference counts jit traces, the port its eager
  steps) and the streamed run's ``overlap`` (a timing), ``waves`` and
  ``max_wave_bytes``: in both packages the default ``"auto"`` rebalancing
  and host lane repack waves once measured wave times pass a 10 ms floor,
  so these follow the host's load.  ``tests/test_torch_stream.py`` holds
  the planned waves to the reference's.
* The two LM examples run a few tokens and steps on the CPU and exit 0
  (the serving one also on the moe, vlm and audio smoke configs).
* ``run(alg, store, ...)`` equals ``compile_plan(...).run()``; the
  deprecated ``Engine`` warns, equals the reference's ``Engine`` on the
  reference tests' stores, and refuses ``backend``/``use_pallas``.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import repro.core as rc
from repro.algorithms import bfs_algorithm as r_bfs
from repro.algorithms import pagerank_algorithm as r_pagerank

import repro_torch.core as tc
from repro_torch.algorithms import bfs_algorithm, pagerank_algorithm

ROOT = pathlib.Path(__file__).resolve().parent.parent
NUMBER = re.compile(r"-?\d+(?:\.\d+)?")
#: numbers that differ by design: jit traces vs eager steps, timings, and
#: the wave packing that "auto" rebalancing derives from timings
UNCOMPARED = re.compile(r"(compile_count|overlap|waves|max_wave_bytes)=-?\d+(?:\.\d+)?")
#: the reference names the TPU's units; the port the path's kind
PATHS = {"MXU/dense": "tile/dense", "VPU/sparse": "edge/sparse"}


def _run(args, **env):
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env))
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _lines(text):
    rows = []
    for line in text.strip().splitlines():
        line = UNCOMPARED.sub(r"\1=?", line)
        for old, new in PATHS.items():
            line = line.replace(old, new)
        rows.append((NUMBER.sub("#", line).split(), NUMBER.findall(line)))
    return rows


@pytest.mark.parametrize("name", ["quickstart", "pipeline", "heterogeneous_schedule"])
def test_graph_example_prints_the_reference_numbers(name):
    want = _lines(_run([f"examples/{name}.py"], JAX_PLATFORMS="cpu"))
    got = _lines(_run([f"examples/torch_{name}.py", "--device", "cpu"]))
    assert len(got) == len(want)
    for (words, nums), (rwords, rnums) in zip(got, want):
        assert words == rwords
        assert len(nums) == len(rnums), (words, nums, rnums)
        for a, b in zip(nums, rnums):
            if "." in a or "." in b:
                assert abs(float(a) - float(b)) <= 1e-5, (words, a, b)
            else:
                assert a == b, (words, nums, rnums)


def test_serve_lm_example_runs():
    out = _run(["examples/torch_serve_lm.py", "--device", "cpu", "--tokens", "3"])
    assert "4 streams × 3 tokens" in out


def test_serve_lm_example_serves_the_moe_smoke_config():
    out = _run(["examples/torch_serve_lm.py", "--device", "cpu", "--arch", "deepseek-moe-16b",
                "--tokens", "3"])
    assert "4 streams × 3 tokens" in out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-base"])
def test_serve_lm_example_serves_the_vlm_and_audio_smoke_configs(arch):
    out = _run(["examples/torch_serve_lm.py", "--device", "cpu", "--arch", arch,
                "--tokens", "3"])
    assert "4 streams × 3 tokens" in out


def test_train_lm_example_runs(tmp_path):
    out = _run(["examples/torch_train_lm.py", "--device", "cpu", "--steps", "3",
                "--ckpt-dir", str(tmp_path / "ckpt")])
    assert re.search(r"qwen-20m: nll \d+\.\d+ -> \d+\.\d+ over 3 steps", out)
    assert os.listdir(tmp_path / "ckpt")


# ------------------------------------------------------- run and Engine
def _stores(args, p):
    return (rc.build_block_store(rc.rmat(*args[:2], seed=args[2]), p),
            tc.build_block_store(tc.rmat(*args[:2], seed=args[2]), p))


def test_run_equals_compile_plan():
    _, store = _stores((9, 8, 23), 4)
    kw = dict(device="cpu", mode="hybrid", dense_density=0.001, tile_dim=128)
    got = tc.run(pagerank_algorithm(), store, **kw)
    want = tc.compile_plan(pagerank_algorithm(), store, **kw).run()
    assert got.iterations == want.iterations
    np.testing.assert_array_equal(got.result, want.result)
    # no "auto" rebalancing or host lane: the waves must not follow the host's load
    kw.update(memory_budget="16KB", rebalance_threshold=None, host_fraction=None)
    got = tc.run(bfs_algorithm(0), store, **kw)
    want = tc.compile_plan(bfs_algorithm(0), store, **kw).run()
    for key in ("dist", "parent"):
        np.testing.assert_array_equal(got.result[key], want.result[key])
    assert got.schedule_stats["streaming"]["num_waves"] == \
        want.schedule_stats["streaming"]["num_waves"]


# the stores of tests/test_system.py:66, :85 and tests/test_plan.py:112
ENGINE_STORES = {"system_probe": ((6, 4, 0), 2, dict(mode="sparse_only")),
                 "system_stats": ((9, 8, 23), 4, dict(mode="hybrid", dense_density=0.001)),
                 "plan_shim": ((7, 8, 11), 4, dict(mode="hybrid", dense_density=0.001))}


@pytest.mark.parametrize("case", list(ENGINE_STORES))
def test_engine_shim_matches_reference(case):
    args, p, kw = ENGINE_STORES[case]
    rstore, store = _stores(args, p)
    for r_alg, alg in ((r_pagerank(), pagerank_algorithm()), (r_bfs(1), bfs_algorithm(1))):
        with pytest.warns(DeprecationWarning):
            want_eng = rc.Engine(r_alg, rstore, **kw)
        with pytest.warns(DeprecationWarning, match="compile_plan"):
            eng = tc.Engine(alg, store, device="cpu", **kw)
        for key in ("num_tasks", "dense_tasks", "makespan_ratio", "dense_weight_frac"):
            assert eng.schedule.stats[key] == want_eng.schedule.stats[key], key
        want, got = want_eng.run(), eng.run()
        assert got.iterations == want.iterations
        if isinstance(got.result, dict):
            for key in ("dist", "parent"):
                np.testing.assert_array_equal(got.result[key], np.asarray(want.result[key]))
        else:
            np.testing.assert_allclose(got.result, np.asarray(want.result), rtol=1e-5,
                                       atol=1e-7)
            assert abs(float(got.result.sum()) - 1.0) < 1e-3


@pytest.mark.parametrize("kw", [dict(use_pallas=True), dict(use_pallas=False),
                                dict(backend="xla")], ids=["use_pallas", "no_pallas", "backend"])
def test_engine_refuses_a_backend_switch(kw):
    _, store = _stores((7, 8, 11), 4)
    with pytest.raises(TypeError, match="device="):
        tc.Engine(pagerank_algorithm(), store, device="cpu", **kw)
