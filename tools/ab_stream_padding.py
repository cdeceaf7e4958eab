#!/usr/bin/env python3
"""A/B of the streamed slabs' padding arcs, on one card, in one process.

A wave slab is padded to its power-of-two bucket with arcs that every
path masks out; the level kernels' scatters still visit them.  Run A
pads with zeros (every padding arc a self-loop at vertex 0, so each of
their atomic updates lands on one address); run B pads as the executor
does, with self-loops spread over the vertices
(``repro_torch.core.stream._spread_padding``).

On ``chip_smoke.py``'s PageRank store (``degree_order(rmat(20, 16,
seed=7))``, p=512, tile_dim 512, hybrid), streamed under a quarter of
the task footprint with fixed waves and no host lane: BFS from the
highest-degree vertex (direction "auto") and PageRank cut to 3
iterations.  Runs A, B, B, A, each under torch.profiler, and prints per
run the wall ms, the device-busy ms and the five busiest kernels; BFS
parent/dist must be equal across all four runs, PageRank within 1e-6.
The last line is a JSON summary.

Usage, from the repository root::

    python tools/ab_stream_padding.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def zero_padding(out, k, n):
    out[k:] = 0


def main() -> int:
    import torch
    from repro_torch.algorithms import bfs_algorithm, pagerank_algorithm
    from repro_torch.core import build_block_store, compile_plan, degree_order, rmat
    from repro_torch.core import stream

    if not torch.cuda.is_available():
        print("ab_stream_padding: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg = cs.PAGERANK
    kw = dict(tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    t0 = time.perf_counter()
    g, _ = degree_order(rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"]),
                        ascending=False)
    store = build_block_store(g, cfg["p"])
    src = int(np.argmax(store.degrees))
    schedule = compile_plan(pagerank_algorithm(), store, device="cpu", **kw).schedule
    store._device_cache.clear()       # the streamed plans hold no in-core copy
    print(f"store {time.perf_counter() - t0:.1f} s, n {g.n}, arcs {g.m}", flush=True)

    fixed = dict(kw, rebalance_threshold=None, host_fraction=None)
    plans = {}
    for name, alg, extra in (("bfs", bfs_algorithm(src), dict(direction="auto")),
                             ("pagerank", pagerank_algorithm(max_iters=3), {})):
        budget = cs.quarter_budget(alg, store, schedule, cs.STREAM_SPLIT)
        plans[name] = compile_plan(alg, store, device=dev, memory_budget=budget,
                                   **fixed, **extra)
        plans[name].run()                          # calibration pass and warm-up
        print(f"{name}: budget {budget / 1e9:.3f} GB, {plans[name].num_waves} waves",
              flush=True)

    spread = stream._spread_padding
    runs, first = [], {}
    for label in ("A", "B", "B", "A"):
        stream._spread_padding = zero_padding if label == "A" else spread
        for name, plan in plans.items():
            res, wall, busy, top = cs.device_profile(plan.run)
            if name in first:
                want = first[name]
                if name == "bfs":
                    ok = all(np.array_equal(res.result[k], want[k]) for k in ("parent", "dist"))
                else:
                    ok = bool(np.allclose(res.result, want, rtol=0, atol=1e-6))
                if not ok:
                    print(f"ab_stream_padding: {name} run {label} differs", file=sys.stderr)
                    return 1
            else:
                first[name] = res.result
            runs.append(dict(run=label, algorithm=name, iterations=res.iterations,
                             wall_ms=wall, busy_ms=busy))
            print(f"{label} {name}: {res.iterations} iterations, {wall:.1f} ms wall, device "
                  f"busy {busy if busy is None else f'{busy:.1f}'} ms; busiest kernels {top} "
                  f"[{card}]", flush=True)
    stream._spread_padding = spread
    for plan in plans.values():
        plan.close()
    print(json.dumps(dict(card=card, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
