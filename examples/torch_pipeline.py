"""The paper's §1 motivating pipeline on the PyTorch port, end to end:

connected components → extract largest component → BFS reorder →
triangle count / clustering, all through the block-based API.  Runs on
the current CUDA device unless `--device cpu`.

    PYTHONPATH=src python examples/torch_pipeline.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.algorithms import afforest_algorithm, bfs_algorithm, triangle_count
from repro_torch.core import build_block_store, compile_plan, from_edges, resolve_device, rmat

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: the current CUDA device")
dev = resolve_device(ap.parse_args().device)

g = rmat(12, 8, seed=42)
print(f"input graph: n={g.n} m={g.m}")

# 1. connected components → giant component
store = build_block_store(g, 4)
comp = compile_plan(afforest_algorithm(), store, device=dev).run().result
labels, counts = np.unique(comp, return_counts=True)
giant = labels[np.argmax(counts)]
members = np.where(comp == giant)[0]
print(f"giant component: {members.size} vertices")

# 2. extract + reindex
remap = -np.ones(g.n, np.int64)
remap[members] = np.arange(members.size)
s, d = g.coo()
keep = (comp[s] == giant) & (comp[d] == giant)
g2 = from_edges(remap[s[keep]], remap[d[keep]], n=members.size)

# 3. BFS from the max-degree vertex → level ordering
store2 = build_block_store(g2, 4)
root = int(np.argmax(np.diff(g2.indptr)))
out = compile_plan(bfs_algorithm(root), store2, device=dev).run().result
order = np.argsort(out["dist"], kind="stable")
perm = np.empty(g2.n, np.int64)
perm[order] = np.arange(g2.n)
s2, d2 = g2.coo()
g3 = from_edges(perm[s2], perm[d2], n=g2.n)
print(f"bfs reorder done (root {root}, depth "
      f"{int(out['dist'][out['dist'] < 2**31-1].max())})")

# 4. triangle count on the reordered graph
nt = triangle_count(g3, p=4, device=dev)
avg_deg = g3.m / g3.n
print(f"triangles: {nt}  (global clustering proxy: "
      f"{3 * nt / max(1, (avg_deg * (avg_deg - 1) / 2) * g3.n):.4f})")
