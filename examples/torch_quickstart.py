"""Quickstart of the PyTorch port: the paper algorithms through the
compiled-Plan API.

Build once (`compile_plan`), execute many times (`plan.run`), reuse the
same plan across graphs with the same padded shapes, and add
`memory_budget=` to stream the same computation out-of-core when the
edge set must not live on the device whole.  Runs on the current CUDA
device unless `--device cpu`.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.algorithms import (
    afforest_algorithm, bfs_algorithm, pagerank_algorithm, sv_algorithm, triangle_count,
)
from repro_torch.core import build_block_store, compile_plan, from_edges, resolve_device, rmat

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: the current CUDA device")
dev = resolve_device(ap.parse_args().device)

# a skewed RMAT graph (kron-class, the paper's hardest case for balance)
g = rmat(12, 8, seed=7)
print(f"graph: n={g.n} m={g.m}")

# partition into 4x4 conformal blocks; compile_plan sends dense blocks to
# the tile kernels and sparse ones to the edge scatters
store = build_block_store(g, 4)

# build once ...
plan = compile_plan(pagerank_algorithm(), store, device=dev)
# ... execute; the schedule is a first-class, inspectable artifact
res = plan.run()
ranks = res.result
st = plan.schedule.stats
print(f"pagerank: sum={ranks.sum():.4f} top vertex={int(np.argmax(ranks))} "
      f"({st['num_tasks']} tasks, {st['dense_tasks']} dense)")

# cross-graph plan reuse: a second graph with the same padded shapes
# runs through the plan's step as it is
perm = np.random.default_rng(1).permutation(g.n)
s, d = g.coo()
g2 = from_edges(perm[s], perm[d], n=g.n)
store2 = build_block_store(g2, 4)
ranks2 = plan.run(store2).result
print(f"pagerank on relabeled graph: sum={ranks2.sum():.4f} "
      f"(compile_count={plan.compile_count})")

comp = compile_plan(sv_algorithm(), store, device=dev).run().result
print(f"shiloach-vishkin: {len(np.unique(comp))} components")

comp2 = compile_plan(afforest_algorithm(), store, device=dev).run().result
print(f"afforest:         {len(np.unique(comp2))} components")

src = int(np.argmax(np.diff(g.indptr)))
out = compile_plan(bfs_algorithm(src), store, device=dev).run().result
reached = int((out["dist"] < 2**31 - 1).sum())
print(f"bfs: reached {reached}/{g.n}, max depth "
      f"{int(out['dist'][out['dist'] < 2**31-1].max())}")

# the one-shot wrappers still exist for quick calls
nt = triangle_count(g, p=4, device=dev)
print(f"triangles: {nt}")

# out-of-core: the same compile_plan call under a device-memory budget
# streams double-buffered waves whose staged bytes each fit the budget
splan = compile_plan(pagerank_algorithm(), store, memory_budget="512KB", device=dev)
sres = splan.run()
st = sres.schedule_stats["streaming"]
print(f"streamed pagerank: sum={sres.result.sum():.4f} "
      f"waves={st['num_waves']} "
      f"max_wave_bytes={max(st['bytes_per_wave'])} (≤ {st['budget_bytes']}) "
      f"overlap={st['overlap_efficiency']:.2f}")
