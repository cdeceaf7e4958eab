#!/usr/bin/env python3
"""A/B of ``chip_smoke.py``'s PageRank and BFS phases between two checkouts, on one card.

Builds the PageRank phase's store once (``degree_order(rmat(20, 16,
seed=7))``, p=512, as ``chip_smoke.py`` does), pickles it, then runs the two
checkouts in the order A, B, B, A, each in a fresh process that imports
``chip_smoke.py`` and ``repro_torch`` from its own checkout and calls its
``phase_pagerank`` and then its ``phase_bfs`` on the pickled store.  Both
checkouts must share the store's classes (``repro_torch.core``).  Each run
prints its phase lines, then one JSON line with the ``spmv_tiles`` and
``frontier_tiles`` records; the last line is a JSON summary of the kernel
times per run, in run order.

Usage, from any directory (the store is pickled under ``ROOT_B/runs/ab``)::

    python tools/ab_graph_phases.py ROOT_A ROOT_B
"""
from __future__ import annotations

import json
import pickle
import subprocess
import sys
import time
from pathlib import Path


def build_store(root: Path, path: Path) -> None:
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core import build_block_store, degree_order, rmat

    cfg = cs.PAGERANK
    t0 = time.perf_counter()
    g, _ = degree_order(rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"]),
                        ascending=False)
    store = build_block_store(g, cfg["p"])
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(store, fh, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"store: n {g.n}, arcs {g.m}, built and pickled in {time.perf_counter() - t0:.1f} s",
          flush=True)


def run_phases(root: Path, path: Path) -> None:
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build_all(["spmv_tiles", "frontier_tiles"])
    with open(path, "rb") as fh:
        store = pickle.load(fh)
    plan, spmv = cs.phase_pagerank(dev, store)
    frontier = cs.phase_bfs(dev, store, plan.schedule)
    print(json.dumps({"root": str(root), "spmv_tiles": spmv, "frontier_tiles": frontier}),
          flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] in ("--store", "--run"):
        root, path = Path(sys.argv[2]).resolve(), Path(sys.argv[3]).resolve()
        (build_store if sys.argv[1] == "--store" else run_phases)(root, path)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (Path(p).resolve() for p in sys.argv[1:])
    path = b / "runs" / "ab" / "store.pkl"
    me = str(Path(__file__).resolve())
    subprocess.run([sys.executable, me, "--store", str(b), str(path)], check=True)
    summary = []
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        print(f"=== run {label}: {root}", flush=True)
        out = subprocess.run([sys.executable, me, "--run", str(root), str(path)],
                             check=True, stdout=subprocess.PIPE, text=True).stdout
        print(out, end="", flush=True)
        rec = json.loads(out.strip().splitlines()[-1])
        summary.append({"run": label, **{k: rec[k]["ms"] for k in ("spmv_tiles",
                                                                   "frontier_tiles")}})
    path.unlink()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
