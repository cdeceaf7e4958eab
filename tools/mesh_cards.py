#!/usr/bin/env python3
"""``chip_smoke.py``'s ``phase mesh`` alone, over every card of the machine.

``chip_smoke.py`` runs the device mesh on whatever cards it finds (two
shards on cuda:0 when there is one).  This script drives the same phase
functions at the same configurations with only what they need: the
PageRank store and its in-core PageRank and BFS runs, single-device
streamed PageRank and BFS (cut to phase mesh's depth, for the
comparison and the budgets), the TC dag with its in-core and streamed
runs, then ``phase_mesh`` and ``phase_mesh_tc``.  Every check of
``chip_smoke.py`` holds here; any failure exits non-zero.  Run from the
repository root on a machine with two or more cards::

    python tools/mesh_cards.py
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.algorithms import bfs_algorithm, pagerank_algorithm
    from repro_torch.core import build_block_store, degree_order, rmat
    from repro_torch.kernels import _build

    if torch.cuda.device_count() < 2:
        print("mesh_cards: needs two or more CUDA devices", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = "; ".join(smi.stdout.strip().splitlines())
    cs.say(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all(["spmv_tiles", "frontier_tiles", "tc_tiles"])
    cs.say(f"build: 3 kernels in {time.perf_counter() - t0:.1f} s")

    cfg = cs.PAGERANK
    t0 = time.perf_counter()
    g, _ = degree_order(rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"]),
                        ascending=False)
    store = build_block_store(g, cfg["p"])
    cs.say(f"phase pagerank: graph + store {time.perf_counter() - t0:.1f} s")
    plan, _, pr_res, _, pr_three = cs.phase_pagerank(dev, store)
    _, bfs_res = cs.phase_bfs(dev, store, plan.schedule)
    schedule = plan.schedule
    del plan
    store._device_cache.clear()
    torch.cuda.empty_cache()
    kw = dict(tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    rate = cs.pinned_h2d_rate(dev)
    runs = {}
    src = int(store.degrees.argmax())
    for name, alg, extra in (("pagerank", pagerank_algorithm(max_iters=cs.MESH_PR_ITERS), {}),
                             ("bfs", bfs_algorithm(src), dict(direction="auto"))):
        budget = cs.quarter_budget(alg, store, schedule, cs.STREAM_SPLIT)
        _, _, _, runs[name] = cs.stream_run(dev, name, alg, store, budget, rate, float("nan"),
                                            **kw, **extra)
    cs.phase_mesh(dev, store, schedule, runs, bfs_res, pr_res, pr_three, card)
    del store, g, schedule
    torch.cuda.empty_cache()

    _, tc_store, tc_schedule, tc_res = cs.phase_tc(dev)
    tc_store._device_cache.clear()
    torch.cuda.empty_cache()
    _, tc_single = cs.phase_stream_tc(dev, tc_store, tc_schedule, tc_res, rate)
    cs.phase_mesh_tc(tc_store, tc_schedule, tc_res, tc_single, cs.card_mesh(card), card)
    cs.say("mesh_cards: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
