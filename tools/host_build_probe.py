#!/usr/bin/env python3
"""Time the host build of ``chip_smoke.py``'s PageRank store alone.

``rmat(20, 16, seed=7)`` and ``degree_order(..., ascending=False)`` are
numpy work on the host, and on the card's machine they take most of
``chip_smoke.py``'s run.  This script times the two in one process,
either before anything touches a card (``plain``) or after CUDA is
initialized (``cuda``), so that a slow build can be told apart from CUDA
start-up.  It prints the CPU count, the numpy version and the two
times.  Run from the repository root::

    python tools/host_build_probe.py plain
    python tools/host_build_probe.py cuda
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv) -> int:
    mode = argv[0] if argv else "plain"
    if mode not in ("plain", "cuda"):
        print("usage: host_build_probe.py [plain|cuda]", file=sys.stderr)
        return 2
    import numpy as np

    if mode == "cuda":
        import torch

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    from repro_torch.core import degree_order, rmat

    t0 = time.perf_counter()
    g = rmat(20, 16, seed=7)
    t1 = time.perf_counter()
    degree_order(g, ascending=False)
    t2 = time.perf_counter()
    print(f"{mode}: {os.cpu_count()} CPUs, numpy {np.__version__}, OMP_NUM_THREADS "
          f"{os.environ.get('OMP_NUM_THREADS', 'unset')}: rmat {t1 - t0:.1f} s, degree_order "
          f"{t2 - t1:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
