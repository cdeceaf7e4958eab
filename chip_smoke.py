#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Builds the six CUDA kernels from ``src/repro_torch/csrc`` (the five Pallas
kernels' counterparts and ``flash_attention``'s backward), holds each
against its plain PyTorch version, and drives the port's main paths at
full configuration: the graph engine through ``compile_plan(...).run()``,
the LM's inference path through ``make_prefill_step`` and
``ServeEngine``, and its training through ``make_train_step``,
``TrainLoop`` and ``launch.train``:

1. kernels vs plain versions on the card, at the main paths' shapes and
   at ragged ones (tile kernels: T=192, odd batch; all three also with
   ragged extents -- tiles zeroed outside a block rectangle whose rows
   are drawn from, and whose columns cycle through, 0, 1, 3, 7, 13, 30,
   63, 65, 100, 200, 300 and T (every lane-group width of each of
   ``spmv_tiles``' routes) -- at T in {64, 192, 512} and at T=50 float32
   and T=36, 37 bf16, whose unaligned rows take ``tc_tiles``' cp.async
   route and ``spmv_tiles``' scalar one, float32 and bf16 tiles, masked
   triples and an empty frontier; ``spmv_tiles``' output must be exactly 0
   past each rectangle's columns; ``flash_attention``:
   the LM prefill's (2, 32 heads, 8 KV heads, 4096, 128) bf16, suffix-
   aligned causal with S_q < S_k, non-causal, and S_q > S_k with rows
   that see no key, each in float32 and bf16, and a bf16 D=64 shape;
   ``spmv_ell``: (B, R, K, N) = (4, 262144, 32, 2^20),
   the PageRank graph's vertex count and mean degree, and two with K
   not a multiple of 4); ``spmv_tiles`` and ``frontier_tiles`` also with
   a query axis, Q in {1, 3, 8}, on the same tiles, each row equal to
   the Q=1 launch on that row bit for bit, one query's frontier empty;
   ``phase kernels backward``: ``flash_attention``'s backward at train_4k's
   attention cut to (2, 32 heads, 8 KV heads, 4096, 128) bf16 causal and
   at ragged, suffix-aligned, non-causal, D=64, float32 shapes and rows
   that see no key, each gradient against the plain version (float32:
   LM_TOL; bf16: relative L2 ≤ 1e-2), the same bits twice, and the
   forward's row log-sum-exp on both routes;
2. PageRank on ``degree_order(rmat(20, 16, seed=7), ascending=False)``
   (the Graph500 Kronecker generator, A=.57 B=.19 C=.19, edge factor
   16; scale cut from Graph500's ≥26 for host build time), p=512,
   tile_dim=512, dense_density=0.005, against a float64 scipy power
   iteration of the same formula;
3. BFS push, pull and auto on the same store from the vertex of highest
   degree, against ``scipy.sparse.csgraph`` distances;
4. Shiloach-Vishkin, Afforest, k-core (k=16) and HITS in-core on the
   same store: components against ``scipy.sparse.csgraph`` (as
   partitions), the k-core against numpy peeling, HITS against a float64
   power iteration of the same formula (relative L1 ≤ 1e-3); the
   pointer-jump sync rounds (one flag read each) are counted;
5. the out-of-core streaming executor on the same store: PageRank, BFS
   (``direction="auto"``) and CC under a ``memory_budget`` of a quarter
   of their total task footprint (≥ 4 waves each), against their
   in-core runs (BFS and CC bit for bit, PageRank also against float64);
   every wave's staged bytes plus workspace within the budget, and
   ``max_memory_allocated`` within ``resident_device_bytes + (depth + 1)
   × budget``; the copies' rate on the copy stream beside one large
   pinned copy's; then the triangle count below streamed under a third
   of its footprint (≥ 2 waves).  Each tile kernel is also timed on a
   wave slab.  Each streamed run prints what ``host_fraction="auto"``
   resolved to (``schedule_stats["hetero"]``);
   ``phase hetero``: the host lane beside the card's waves, on the same
   store and budgets, ``host_fraction=0.3``: CC (Afforest, sparse) and
   BFS auto bit for bit against in-core (labels; parent, dist and the
   per-level decisions), PageRank (hybrid, 5 iterations) within rtol
   1e-5 of an in-core run of 5 iterations, with ``spmv_tiles`` launched
   on the device waves; per run the split, host units and tasks, staged
   bytes and ms per iteration beside the device-only run's, the device
   and host makespans, the stall and ``host_stage_overlap``;
   ``phase resilience``: streamed CC with ``host_fraction=0.3`` and four
   injected faults (assembly, an OOM at a copy, a wave, a host unit)
   recovered to the fault-free labels; streamed and in-core BFS auto
   checkpointed every level and resumed from level 3 bit for bit; a real
   ``torch.cuda.OutOfMemoryError`` classified as ``oom`` and a normal
   allocation after it.  Every fault-free plan must have detected no
   failure, demoted nothing and kept its host lane;
   ``phase serve``: ``GraphServer`` on the same store, in-core: 8
   personalized PageRank queries (1-3 seeds), 8 BFS queries
   (``direction="auto"``, from the vertex of highest degree and 7 drawn
   ones), a 16-core and a CC query, as 4 batches; BFS, k-core and CC
   equal their solo runs bit for bit, PageRank its solo runs within
   rtol 1e-5 / atol 1e-7 and float64 scipy within the L1 limit;
   ``spmv_tiles`` launches once per iteration of the PageRank batch,
   ``frontier_tiles`` once per pull level of the BFS batch; then
   streamed under the quarter budget with a serving budget of resident +
   3 queries: 4 PageRank queries of 3 iterations queue, run in batches
   within the budget and equal their solo streamed runs.  Prints each
   batch, amortized against solo ms, latency, priced high water beside
   the allocator's growth, and the batched kernels at Q=8 on the path's
   inputs beside 8 Q=1 launches;
   ``phase mesh``: the device mesh from one controller, over every card as
   one shard each when there are two or more, else two shards on cuda:0
   (``DeviceMesh(["cuda:0"] * 2)``), each shard under phase stream's
   budget: PageRank hybrid (3 iterations) within rtol 1e-5 / atol 1e-7 of
   an in-core run of 3 iterations, BFS auto bit for bit (parents,
   distances, decisions) against in-core, and the DistributedEngine's
   PageRank (the reference test's edge update, 20 steps) within 1e-5 of
   in-core; after TC below, TC hybrid streamed under the mesh, exactly the
   in-core count.  Each run checks the shard count, every shard's staged
   bytes + workspace within its budget, bytes across the combine, each
   card's peak memory within its resident bytes + (depth + 1) × its
   shards' budgets, and the path's tile kernel launched on every shard
   that held tiles; it prints waves, GB staged per device per iteration,
   ms per iteration beside the single-device streamed run's and the
   combine's time per wave (CUDA events);
6. triangle counting on ``orient_dag(rmat(16, 16, seed=7))``, p=256,
   tile_dim=512, dense_density=0.001, against an exact scipy count;
   ``phase suite``: ``benchmark_suite("bench")`` (the paper's seven graph
   classes, 0.13-0.94 M arcs) at table 1's plan settings
   (``benchmarks/table1_graphs.py``: p=4, hybrid, dense_density=0.001,
   tile_dim=512): PageRank, SV, Afforest, BFS from 0 and TC (on the DAG) on
   every graph, 35 runs, each against float64 scipy or scipy's exact answer
   (none takes the dense path there); then kron, social and twitter at the
   chip layout (descending degree order, p = n / 512, tile_dim 512,
   dense_density 0.005, TC 0.001): PageRank, BFS auto and TC, each equal to
   its table-1 run through the permutation, with ``spmv_tiles``,
   ``frontier_tiles`` and ``tc_tiles`` each launched; then one streamed
   PageRank on kron (3 iterations, at least 4 waves, pipeline depth 2)
   traced, exported with ``repro_torch.obs.export.write_chrome_trace`` into
   a temporary directory and validated (lanes main, staging, device/0;
   every wave in each phase), the device lane's span ms beside
   ``torch.profiler``'s device busy ms.  Its numbers print as one
   ``run_report("chip_suite", ...)`` JSON line; the phase must take at
   most 60 s;
7. LM exactness: granite-3-8b at full width, depth cut to 2 layers,
   float32, TF32 off: the prefill logits with the kernel equal those
   without it, cached decode reproduces them over 16 positions, and
   ``ServeEngine``'s greedy outputs in a batch equal the solo runs;
8. LM at full size: granite-3-8b, 40 layers, bfloat16, seeded random
   weights on the card.  ``make_prefill_step(use_kernel=True)`` on
   2 × 4096 tokens (``prefill_32k`` cut from 32 × 32768) launches
   ``flash_attention`` once per layer and gives a loss near ln V; a
   profiled window of decode steps gives the device's idle share, and
   ``ServeEngine(batch_slots=4, cache_len=512)`` serves 8 requests;
9. training exactness: granite-3-8b at full width, 2 layers, float32, TF32
   off, batch 2 × 256: one ``make_train_step`` step with the kernels
   against one without from the same weights (loss and grad_norm within
   LM_TOL, every updated parameter within the reference's resume
   tolerance), ``microbatch=2`` the same loss, and ten steps on one
   repeated batch that lower the loss below 0.8 of its first value;
10. training at full width: granite-3-8b, depth cut to 8 layers (2.0 B
   parameters, 24.0 GB of bf16 weights and gradients and float32
   moments; 40 layers would need 100 GB), bf16, seeded weights,
   ``train_4k`` cut from 256 × 4096 to 2 × 4096 in two microbatches,
   remat "full", the kernels on: a warm-up step, three timed steps (ms a
   step, tokens/s, the model-FLOPs share of 989 TFLOP/s), a profiled
   step (idle share), peak memory, and the kernels' launches a step
   (``flash_attention`` twice a layer a microbatch under remat, its
   backward once);
11. ``python -m repro_torch.launch.train`` on the smoke config, then a
   ``TrainLoop`` cut after 3 of 6 steps and resumed, equal to the
   uninterrupted run.

Each path resets the kernels' launch counts just before it is driven and
reads them just after.  Then each kernel is timed on the inputs that
path gave it (CUDA events), beside its plain version, a one-call
PyTorch yardstick where there is one, and its bound: the larger of the
bytes it must move over 3.35 TB/s and its operations over the card's
peak rate for their type (H100 SXM data sheet: 67 TFLOP/s float32 on
the CUDA cores; 989 TFLOP/s bf16 dense on the tensor cores for the
attention products, which no float32 arithmetic is needed for; 495
TFLOP/s TF32 for ``tc_tiles``' wedge products, exact on 0/1 tiles).
The tile kernels' bounds count only what lies inside each tile's block
rectangle (its extents); the whole-tile bound they had before is printed
beside.  Any failed check exits non-zero.

Output: the card's name and power limit, the build time, the registers and
spills (ptxas) of flash_attention and its backward, tc_tiles, spmv_tiles and
spmv_ell, the
tensor-core and TMA instructions (cuobjdump) of flash_attention (the bf16
route must have both) and tc_tiles (every route of its count kernel must
have HGMMA, the TMA route UTMALDG), one or more
lines per phase, phase suite's run report as a JSON line,
a JSON line of per-kernel numbers, and as the last line
``{"ok": true, "device": {...}}``.  Run from the repository root::

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM: 80 GB HBM3 at 3.35 TB/s
F32_FLOPS = 67e12              # H100 SXM: float32 outside the tensor cores
BF16_TC_FLOPS = 989e12         # H100 SXM: bf16 dense on the tensor cores
TF32_TC_FLOPS = 495e12         # H100 SXM: TF32 dense on the tensor cores
INT_MAX = 2**31 - 1

PAGERANK = dict(scale=20, edge_factor=16, seed=7, p=512, tile_dim=512, dense_density=0.005)
TC = dict(scale=16, edge_factor=16, seed=7, p=256, tile_dim=512, dense_density=0.001)
#: phase 1 shapes: PageRank's (nd, T), TC's (nd, B, T), and ragged ones
SPMV_SHAPES = ((4128, 512), (33, 192))
TC_SHAPES = ((3199, 9670, 512), (33, 77, 192))
#: extents checks of the two tile kernels: (T, tile dtype); T=50 float32 and
#: T=36, 37 bf16 have rows that are not 16-byte aligned (tc_tiles' cp.async route)
EXTENT_SHAPES = ((64, "float32"), (192, "float32"), (512, "float32"), (64, "bfloat16"),
                 (192, "bfloat16"), (512, "bfloat16"), (50, "float32"), (36, "bfloat16"),
                 (37, "bfloat16"))
#: extents of the ragged rectangles besides 0 and T (clamped to T): a width of
#: each power-of-two lane group of spmv_tiles' routes (V = 1, 4 or 8 columns
#: a lane, 1 to 256 lanes), and 300, a rectangle whose second panel is ragged
EXTENT_CHOICES = (0, 1, 3, 7, 13, 30, 63, 65, 100, 200, 300)
#: batch of the extents checks (odd): tiles (enough that the columns take every
#: choice twice), triples (enough that some triples' boxes are wide in all
#: three directions and count triangles)
EXTENT_BATCH = (27, 601)
PAGERANK_L1_TOL = 1e-5         # float32 ranks vs float64, same iteration count
#: phase algorithms: k-core's k; HITS hubs and authorities (float32) vs a
#: float64 power iteration of the same formula over the same iterations,
#: L1 distance relative to the float64 vector's L1 norm
KCORE_K = 16
HITS_REL_L1_TOL = 1e-3
#: phase stream: budgets are the schedule's total task footprint over these
#: (PageRank, BFS and CC pack at least 4 waves, TC at least 2); streamed
#: PageRank's depth, cut for run time (its in-core reference is cut alike)
STREAM_SPLIT = 4
TC_STREAM_SPLIT = 3
STREAM_PR_ITERS = 5
#: one pinned host→device copy that measures the H2D rate
H2D_PROBE_BYTES = 1 << 30
#: phase hetero: the host lane's fixed share; PageRank's depth (iterations)
HOST_FRACTION = 0.3
HETERO_PR_ITERS = STREAM_PR_ITERS     # one in-core reference serves both
HETERO_PR_RTOL = 1e-5
#: phase resilience: one fault at each seam, recovered in one iteration
FAULTS = ("stage.assemble:raise:at(1);stage.device_put:oom:at(2);"
          "wave.compute:raise:at(1);host.task:raise:once")
FAULT_RETRIES = 6               # four faults in one iteration, beyond the default 3
RESUME_STEP = 3
SPMV_RTOL, SPMV_ATOL = 1e-5, 1e-6   # float32 sums in another order
#: batched tile-kernel checks: query counts (one group of 1, 4 and 8 queries)
BATCH_QS = (1, 3, 8)
#: phase serve: GraphServer's batch cap; PageRank queries' tolerance, depth
#: in-core and streamed (cut to keep the run's time), seeds per query
SERVE_MAX_BATCH = 8
SERVE_TOL = 1e-4
SERVE_PR_ITERS = 20
SERVE_STREAM_ITERS = 3
#: streamed queries (of the in-core phase's seed sets), cut from 8 to 4 for run time:
#: two batches of two and four solo runs to hold them against
SERVE_STREAM_QUERIES = 4
SERVE_SEEDS = (1, 3)
#: batched PageRank rows vs their solo runs: both index_adds are atomic float
#: adds, so the sums differ in order.  Per element the repo's PageRank
#: tolerance (rtol 1e-5, atol 1e-7, tests/test_stream.py); over the vector an
#: L1 distance a tenth of PAGERANK_L1_TOL
SERVE_PR_RTOL, SERVE_PR_ATOL, SERVE_PR_L1 = 1e-5, 1e-7, 1e-6
#: phase mesh: shards on one card when only one exists; streamed PageRank's
#: depth (cut for run time) and its tolerance against in-core (the reference
#: mesh tests' per element, phase serve's over the vector); the
#: DistributedEngine's iterations (tests/test_distributed.py) and its largest
#: difference to the in-core ranks
MESH_SHARDS = 2
MESH_PR_ITERS = 3
MESH_PR_RTOL, MESH_PR_ATOL, MESH_PR_L1 = 1e-5, 1e-7, SERVE_PR_L1
MESH_DIST_ITERS = 20
MESH_DIST_TOL = 1e-5
#: phase suite: table 1's plan settings (benchmarks/table1_graphs.py:31-38) on
#: benchmark_suite("bench"); the chip layout (section 4 of PERF.md: descending
#: degree order, p = ceil(n / tile_dim)) on the skewed classes; the traced
#: streamed PageRank (its budget the footprint over STREAM_SPLIT); the chip
#: layout's PageRank against table 1's; the phase's own time limit
SUITE_TABLE1 = dict(p=4, mode="hybrid", dense_density=0.001, tile_dim=512)
SUITE_CHIP = dict(tile_dim=512, dense_density=0.005, tc_dense_density=0.001)
SUITE_CHIP_GRAPHS = ("kron", "social", "twitter")
SUITE_TRACE = dict(graph="kron", iterations=3, pipeline_depth=2, min_waves=4)
SUITE_PR_RTOL = 1e-5
SUITE_SECONDS = 60.0

#: flash_attention checks: (B, H, H_kv, S_q, S_k, D, dtype, causal); the first is
#: the LM prefill's shape; then suffix-aligned causal with S_q < S_k, non-causal,
#: and S_q > S_k with 256 rows that see no key, in float32 (the CUDA-core route)
#: and bf16 (the tensor-core route); last a bf16 D=64 shape
ATTN_SHAPES = ((2, 32, 8, 4096, 4096, 128, "bfloat16", True),
               (1, 4, 4, 128, 512, 64, "float32", True),
               (1, 2, 2, 256, 256, 128, "float32", False),
               (1, 4, 2, 384, 128, 128, "float32", True),
               (1, 4, 4, 128, 512, 64, "bfloat16", True),
               (1, 2, 2, 256, 256, 128, "bfloat16", False),
               (1, 4, 2, 384, 128, 128, "bfloat16", True),
               (2, 8, 2, 2048, 2048, 64, "bfloat16", True))
#: flash_attention vs the plain version's float32 result (before its cast to
#: the output dtype): |got - want| <= atol + rtol * |want|.  float32: the same
#: sums in another order (tests/test_kernels.py's 2e-4); bfloat16: those sums
#: plus the output's rounding, at most half a bf16 step, 2^-8 of the value
ATTN_TOL = {"float32": dict(rtol=0.0, atol=2e-4), "bfloat16": dict(rtol=2**-8, atol=1e-4)}
#: spmv_ell checks: (B, R, K, N), PageRank's vertex count and mean degree (K = 32,
#: the int4 route), and two whose K takes the scalar route (not a multiple of 4)
ELL_SHAPES = ((4, 262144, 32, 1048576), (3, 200, 7, 500), (2, 40000, 13, 65536))
LM_ARCH = "granite-3-8b"
#: phase 5: depth cut to 2 layers at full width, float32
LM_EXACT = dict(n_layers=2, batch=2, seq=256, decode=16, requests=4, new_tokens=8)
#: the reference's decode-vs-prefill tolerance (tests/test_archs.py)
LM_TOL = dict(atol=2e-4, rtol=1e-3)
#: phase 6: prefill_32k cut to 2 x 4096; 8 requests through 4 slots
LM_FULL = dict(batch=2, seq=4096, slots=4, cache_len=512, requests=8, new_tokens=32,
               prompt=(16, 64))
#: decode steps in the profiled window of phase 6
DECODE_PROFILE_STEPS = 8
#: phase kernels, backward: (B, H, H_kv, S_q, S_k, D, dtype, causal).  The first is
#: the attention of train_4k cut to 2 x 4096 at granite-3-8b's heads (phase train
#: runs it as two microbatches of 1 x 4096); then suffix-aligned causal with
#: S_q < S_k, S not a multiple of 128, non-causal, and S_q > S_k with rows that see
#: no key, in float32 and bf16, D = 64 and 128
BWD_SHAPES = ((2, 32, 8, 4096, 4096, 128, "bfloat16", True),
              (1, 4, 4, 128, 512, 64, "float32", True),
              (1, 4, 2, 200, 333, 64, "float32", True),
              (1, 2, 2, 256, 256, 128, "float32", False),
              (1, 4, 2, 384, 128, 128, "float32", True),
              (1, 4, 4, 128, 512, 64, "bfloat16", True),
              (2, 8, 2, 300, 300, 128, "bfloat16", True),
              (1, 2, 2, 256, 256, 128, "bfloat16", False),
              (1, 4, 2, 384, 128, 128, "bfloat16", True))
#: the backward against its plain version: float32 within LM_TOL; bf16 inputs per
#: tensor ||got - want||_2 / ||want||_2 <= BWD_BF16_REL, want in float32 from the
#: same bf16 inputs.  The bf16 route's products are bf16 with float32 sums, P and dS
#: are rounded to bf16 before theirs, Delta comes from the forward's bf16 output and
#: the gradients are rounded to bf16: 2.3e-3 to 2.5e-3 emulated on the CPU
#: (tests/test_torch_attention_numerics.py), a quarter of the limit
BWD_BF16_REL = 1e-2
#: the forward's lse against the plain version's (float32 sums in another order)
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
#: phase train exact: depth cut to 2 layers at full width, float32, TF32 off
TRAIN_EXACT = dict(n_layers=2, batch=2, seq=256, steps=10)
#: the reference's updated-parameter tolerance (its resume check,
#: tests/test_substrates.py); an element whose gradient is within 100x Adam's eps
#: (|g| < 1e-6, read from the first moment) is held to twice the learning rate
STEP_TOL = dict(atol=1e-5, rtol=1e-4)
#: ten steps on one repeated batch: the last loss below this share of the first
#: (the reference's smoke models are held to 0.8, tests/test_archs.py)
LOSS_DROP = 0.8
#: phase train: train_4k cut from 256 x 4096 to 2 x 4096 in two microbatches, depth
#: cut to 8 layers (bf16 weights and gradients and float32 moments, 12 bytes a
#: parameter: 40 layers are 100 GB, 8 layers 24.0 GB); one warm-up step, timed steps
TRAIN = dict(n_layers=8, batch=2, seq=4096, microbatch=2, timed=3)
#: phase train loop: the smoke config, a run cut after `cut` steps and resumed
TRAIN_LOOP = dict(steps=6, cut=3, batch=4, seq=64)
#: a model with random weights predicts about as well as chance: |loss - ln V| bound
LOSS_BAND = 1.5

SOURCES = {
    "spmv_tiles": ("src/repro_torch/csrc/spmv_tiles.cu", "src/repro/kernels/spmv_tile.py:32"),
    "frontier_tiles": ("src/repro_torch/csrc/frontier_tiles.cu",
                       "src/repro/kernels/frontier_tile.py:48"),
    "tc_tiles": ("src/repro_torch/csrc/tc_tiles.cu", "src/repro/kernels/tc_tile.py:48"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/attn_tile.py:82"),
    "spmv_ell": ("src/repro_torch/csrc/spmv_ell.cu", "src/repro/kernels/spmv_ell.py:38"),
    # the Pallas kernel has no backward of its own: this is its gradient
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/attn_tile.py:82"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_error(got, q, k, v, causal: bool = True) -> tuple[float, float]:
    """flash_attention's output against the plain version's float32 result:
    (max |got - want|, largest share of ATTN_TOL used; above 1 fails)."""
    from repro_torch.kernels import ref

    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    tol = ATTN_TOL[str(q.dtype).removeprefix("torch.")]
    diff = (got.float() - want).abs()
    share = float((diff / (tol["atol"] + tol["rtol"] * want.abs())).max())
    return float(diff.max()), share


def record(name, launches, err, ms, plain_ms, nbytes, ops, library_ms, rate=F32_FLOPS,
           kernel=None):
    """One kernel's row of the JSON line; ``kernel`` names the source of a
    row whose name is not a kernel's (a batched form)."""
    bound_ms, bound_by = bound(nbytes, ops, rate)
    source, replaces = SOURCES[kernel or name]
    rec = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=int(launches), max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    say(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
        f"{bound_ms:.4f} ms ({bound_by}), launches {launches}, max_abs_err {err}")
    return rec


def _route(kernel: str, mangled: str) -> str:
    """The route of a kernel from its mangled name: flash_attention's
    type and head width; for tc_tiles, which of its two kernels (the
    patch-mask pre-pass or the count), the tile type and the load route;
    for spmv_tiles and spmv_ell, the type and the load route."""
    if kernel == "spmv_tiles":
        v = re.search(r"kernelI(?:f|13__nv_bfloat16)Li(\d+)E", mangled).group(1)
        dtype = "bf16" if "bfloat16" in mangled else "f32"
        return f"{dtype} {'scalar' if v == '1' else f'16-byte ({v} elements)'}"
    if kernel == "spmv_ell":
        dtype = "bf16" if "bfloat16" in mangled else "f32"
        return f"{dtype} {'int4' if 'Lb1E' in mangled else 'scalar'}"
    if kernel == "flash_attention":
        if "fill_inf" in mangled:
            return "lse fill (no key)"
        d = re.search(r"kernelILi(\d+)E", mangled).group(1)
        return f"{'bf16' if 'tc6kernel' in mangled else 'f32'} D={d}"
    if kernel == "flash_attention_bwd":
        dtype = "bf16" if "bfloat16" in mangled else "f32"
        if "delta_kernel" in mangled:
            return f"delta {dtype}"
        d = re.search(r"kernelILi(\d+)E", mangled).group(1)
        part = "dkdv" if re.search(r"kv6kernel|dkdv_kernel", mangled) else "dq"
        return f"{part} {dtype} D={d}"
    dtype = "bf16" if "bfloat16" in mangled else "f32"
    if "patch_masks" in mangled:
        return f"masks {dtype} {'16-byte' if 'Lb1E' in mangled else 'scalar'}"
    return f"count {dtype} {'TMA' if 'Lb1E' in mangled else 'cp.async'}"


def tensor_core_report(logs: dict) -> None:
    """ptxas's registers and spills per kernel and route of flash_attention,
    its backward, tc_tiles, spmv_tiles and spmv_ell; for flash_attention,
    its backward and tc_tiles, the register counts the warpgroups set
    (``setmaxnreg``), and the tensor-core (HGMMA) and TMA (UTMALDG)
    instructions in their SASS.  Fails if flash_attention's bf16 route or
    the bf16 dK/dV or dQ kernel of its backward lacks either, or a route
    of tc_tiles' count kernel has no HGMMA (or its TMA route no UTMALDG);
    says so when the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    for kernel in ("flash_attention", "flash_attention_bwd", "tc_tiles", "spmv_tiles",
                   "spmv_ell"):
        name = ""
        for line in logs[kernel].splitlines():
            if "Compiling entry function" in line:
                name = _route(kernel, line)
            elif name and ("registers" in line or "spill" in line):
                say(f"  {kernel} ptxas {name}: {line.split(':', 1)[-1].strip()}")
    for kernel in ("flash_attention", "flash_attention_bwd", "tc_tiles"):
        if not os.path.exists(tool):
            say(f"  {kernel} SASS: not read (no cuobjdump)")
            continue
        sass = subprocess.run([tool, "-sass", str(_build.library_path(kernel))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            route = _route(kernel, fn.split("\n", 1)[0])
            hgmma, utmaldg = fn.count("HGMMA"), fn.count("UTMALDG")
            top = max((int(r) for r in re.findall(r"\bR(\d+)\b", fn)), default=0)
            nreg = sorted(set(re.findall(r"USETMAXREG\.(\w+)\.CTAPOOL[^,;]*,? *(0x[0-9a-f]+)",
                                         fn)))
            say(f"  {kernel} SASS {route}: HGMMA {hgmma}, UTMALDG {utmaldg}, registers "
                f"up to R{top}, setmaxnreg {[(k, int(v, 16)) for k, v in nreg]}")
            if kernel == "flash_attention" and route.startswith("bf16") or \
                    kernel == "flash_attention_bwd" and " bf16 " in route:
                check(hgmma > 0 and utmaldg > 0, f"{kernel} {route}: no HGMMA or UTMALDG")
            if kernel == "tc_tiles" and route.startswith("count"):
                check(hgmma > 0, f"tc_tiles {route}: no HGMMA")
                check(utmaldg > 0 or "TMA" not in route, f"tc_tiles {route}: no UTMALDG")


def device_profile(run, top: int | None = 5):
    """Run ``run()`` under torch.profiler: (result, wall ms, device-busy
    ms, [(kernel, ms)] for the ``top`` busiest kernels, all of them for
    None).  An exception from
    ``run`` propagates; where the profiler itself fails, the busy time is
    None and the last item says why."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # the profiler's own failure: time the run without it
        prof, why = None, f"{type(e).__name__}: {e}"
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if prof is None:
        return out, wall, None, why
    try:
        prof.stop()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    except Exception as e:  # the profiler's own failure
        return out, wall, None, f"{type(e).__name__}: {e}"
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    ranked = sorted(evs, key=lambda e: -e.self_device_time_total)[:top]
    return out, wall, busy, [(e.key[:60], e.self_device_time_total / 1e3) for e in ranked]


def ragged(tiles, gen, dev):
    """``tiles`` zeroed in place outside random extents: rows drawn from
    EXTENT_CHOICES and T, columns cycling through them from a random
    start, so that a batch of 2 + 12 k tiles takes each width k times (the
    first two tiles: 0 x T and T x 0); returns the extents."""
    import torch

    nd, t = tiles.shape[0], tiles.shape[1]
    choices = torch.tensor([*EXTENT_CHOICES, t], dtype=torch.int32, device=dev).clamp_max(t)
    k = len(choices)
    rows = choices[torch.randint(0, k, (nd,), generator=gen, device=dev)]
    start = torch.randint(0, k, (1,), generator=gen, device=dev)
    cols = choices[(torch.arange(nd, device=dev) + start) % k]
    rows[:2] = torch.tensor([0, t], dtype=torch.int32, device=dev)[:nd]
    cols[:2] = torch.tensor([t, 0], dtype=torch.int32, device=dev)[:nd]
    pos = torch.arange(t, device=dev)
    tiles.mul_((pos[None, :, None] < rows[:, None, None]).to(tiles.dtype))
    tiles.mul_((pos[None, None, :] < cols[:, None, None]).to(tiles.dtype))
    return rows, cols


def check_tile_kernels(tiles, idx, f, extents, what):
    """frontier_tiles and tc_tiles against their plain versions (which read
    whole tiles) on the same inputs, with ``extents`` and without."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.frontier_tiles import frontier_tiles_cuda
    from repro_torch.kernels.tc_tiles import tc_tiles_cuda

    want = ref.frontier_tiles_ref(tiles, f)
    for ext in (None, extents):
        check(torch.equal(frontier_tiles_cuda(tiles, f, ext), want),
              f"frontier_tiles {what} extents={ext is not None} vs plain")
        empty = frontier_tiles_cuda(tiles, torch.zeros_like(f), ext)
        check(bool((empty == INT_MAX).all()),
              f"frontier_tiles {what} extents={ext is not None}: empty frontier")
    plain = int(ref.tc_tiles_idx_ref(tiles, idx))
    for ext in (None, extents):
        got = int(tc_tiles_cuda(tiles, idx, ext))
        check(got == plain, f"tc_tiles {what} extents={ext is not None}: kernel {got} "
              f"vs plain {plain}")
    return plain


def check_spmv(tiles, xs, extents, what):
    """spmv_tiles against its plain version (which reads whole tiles) on the
    same inputs, without extents and with them; with them, ys must be
    exactly 0 past each rectangle's columns.  The absolute tolerance is
    SPMV_ATOL scaled by max|want| where that is below 1 (PageRank's ys are
    ~1e-5), so that it stays below the values it checks.  Returns the
    largest error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_tiles import spmv_tiles_cuda

    want = ref.spmv_tiles_ref(tiles, xs)
    atol = SPMV_ATOL * min(1.0, float(want.abs().max()))
    err = 0.0
    for ext in (None, extents):
        got = spmv_tiles_cuda(tiles, xs, ext)
        err = max(err, float((got - want).abs().max()))
        check(torch.allclose(got, want, rtol=SPMV_RTOL, atol=atol),
              f"spmv_tiles {what} extents={ext is not None} vs plain: max err {err}")
    past = torch.arange(tiles.shape[1], device=tiles.device)[None, :] >= extents[1][:, None]
    check(bool((got[past] == 0).all()), f"spmv_tiles {what}: ys not 0 past the rectangles")
    return err


def check_batched(tiles, extents, gen, dev, what):
    """spmv_tiles and frontier_tiles with a query axis, Q in BATCH_QS,
    against their plain versions; each row must equal the Q = 1 launch on
    that row bit for bit, and one query's empty frontier must give
    INT32_MAX.  Returns spmv_tiles' largest error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.frontier_tiles import frontier_tiles_cuda
    from repro_torch.kernels.spmv_tiles import spmv_tiles_cuda

    nd, t = tiles.shape[0], tiles.shape[1]
    err = 0.0
    for q in BATCH_QS:
        xs = torch.rand((q, nd, t), generator=gen, device=dev).to(tiles.dtype)
        want = ref.spmv_tiles_ref(tiles, xs)
        got = spmv_tiles_cuda(tiles, xs, extents)
        err = max(err, float((got - want).abs().max()))
        atol = SPMV_ATOL * min(1.0, float(want.abs().max()))
        check(torch.allclose(got, want, rtol=SPMV_RTOL, atol=atol),
              f"spmv_tiles {what} Q={q} vs plain: max err {err}")
        for i in range(q):
            check(torch.equal(got[i], spmv_tiles_cuda(tiles, xs[i], extents)),
                  f"spmv_tiles {what} Q={q}: row {i} != its Q=1 launch")
        f = torch.rand((q, nd, t), generator=gen, device=dev) < 0.3
        f[q // 2] = False                       # one query with an empty frontier
        got = frontier_tiles_cuda(tiles, f, extents)
        check(torch.equal(got, ref.frontier_tiles_ref(tiles, f)),
              f"frontier_tiles {what} Q={q} vs plain")
        check(bool((got[q // 2] == INT_MAX).all()), f"frontier_tiles {what} Q={q}: empty row")
        for i in range(q):
            check(torch.equal(got[i], frontier_tiles_cuda(tiles, f[i], extents)),
                  f"frontier_tiles {what} Q={q}: row {i} != its Q=1 launch")
    return err


def phase_kernels(dev, gen) -> None:
    """Each kernel against its plain version at the main path's shapes
    (PageRank's 4128 tiles, TC's 9670 triples over 3199 tiles) and at a
    ragged T=192 with an odd batch; the three tile kernels also with
    ragged extents, spmv_tiles and frontier_tiles at the SPMV_SHAPES, all
    three at the EXTENT_SHAPES."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.frontier_tiles import frontier_tiles_cuda

    def tiles_of(nd, t, density=0.01, dtype=torch.float32):
        return (torch.rand((nd, t, t), generator=gen, device=dev) < density).to(dtype)

    def triples(nd, nb):
        idx = torch.randint(0, nd, (nb, 3), generator=gen, device=dev, dtype=torch.int32)
        idx[::13] = -1                                  # masked padding triples
        return idx

    for nd, t in SPMV_SHAPES:
        tiles = tiles_of(nd, t)
        xs = torch.rand((nd, t), generator=gen, device=dev)
        whole = torch.full((nd,), t, dtype=torch.int32, device=dev)
        err = check_spmv(tiles, xs, (whole, whole), f"({nd},{t})")
        berr = check_batched(tiles, (whole, whole), gen, dev, f"({nd},{t})")
        f = torch.rand((nd, t), generator=gen, device=dev) < 0.3
        check(torch.equal(frontier_tiles_cuda(tiles, f), ref.frontier_tiles_ref(tiles, f)),
              f"frontier_tiles ({nd},{t}) vs plain")
        extents = ragged(tiles, gen, dev)
        check(torch.equal(frontier_tiles_cuda(tiles, f, extents),
                          ref.frontier_tiles_ref(tiles, f)),
              f"frontier_tiles ({nd},{t}) ragged extents vs plain")
        empty = frontier_tiles_cuda(tiles, torch.zeros_like(f), extents)
        check(bool((empty == INT_MAX).all()), f"frontier_tiles ({nd},{t}) empty frontier")
        err = max(err, check_spmv(tiles, xs, extents, f"({nd},{t}) ragged"))
        berr = max(berr, check_batched(tiles, extents, gen, dev, f"({nd},{t}) ragged"))
        say(f"phase kernels: spmv_tiles, frontier_tiles ok at nd={nd} T={t} with whole and "
            f"ragged extents (spmv_tiles max err {err:.2e}), and with Q in {BATCH_QS} queries, "
            f"each row equal to its Q=1 launch (max err {berr:.2e})")
        del tiles, xs, f, empty
    for nd, nb, t in TC_SHAPES:
        tiles = tiles_of(nd, t)
        idx = triples(nd, nb)
        f = torch.rand((nd, t), generator=gen, device=dev) < 0.3
        whole = check_tile_kernels(tiles, idx, f, None, f"({nd},{nb},{t})")
        cropped = check_tile_kernels(tiles, idx, f, ragged(tiles, gen, dev),
                                     f"({nd},{nb},{t}) ragged")
        say(f"phase kernels: tc_tiles ok at nd={nd} B={nb} T={t} (count {whole}; "
            f"{cropped} with ragged extents)")
        del tiles, idx, f
    nd, nb = EXTENT_BATCH
    for t, dtype in EXTENT_SHAPES:
        tiles = tiles_of(nd, t, 0.2, getattr(torch, dtype))
        extents = ragged(tiles, gen, dev)
        idx = triples(nd, nb)
        for fdtype in (torch.bool, torch.float32, torch.bfloat16):
            f = (torch.rand((nd, t), generator=gen, device=dev) < 0.3).to(fdtype)
            count = check_tile_kernels(tiles, idx, f, extents, f"({nd},{nb},{t}) {dtype}")
        xs = torch.rand((nd, t), generator=gen, device=dev).to(tiles.dtype)
        err = check_spmv(tiles, xs, extents, f"({nd},{t}) {dtype} ragged")
        berr = check_batched(tiles, extents, gen, dev, f"({nd},{t}) {dtype} ragged")
        say(f"phase kernels: frontier_tiles, tc_tiles, spmv_tiles ok at nd={nd} B={nb} T={t} "
            f"{dtype} with ragged extents and without (count {count}, spmv_tiles max err "
            f"{err:.2e}); Q in {BATCH_QS} ok (max err {berr:.2e})")
    torch.cuda.empty_cache()


def ell_inputs(dev, gen, b, r, k, n):
    """Padded neighbour lists: row r holds a random number of valid
    entries in [0, K] (mean K/2) first, then padding."""
    import torch

    idx = torch.randint(0, n, (b, r, k), generator=gen, device=dev, dtype=torch.int32)
    deg = torch.randint(0, k + 1, (b, r, 1), generator=gen, device=dev)
    valid = torch.arange(k, device=dev) < deg
    x = torch.rand((b, n), generator=gen, device=dev)
    return idx, valid, x


def phase_lm_kernels(dev, gen):
    """flash_attention and spmv_ell against their plain versions at the
    shapes of ATTN_SHAPES and ELL_SHAPES.  Returns spmv_ell's record
    (timed on the first shape): no path of the port calls it, so its
    launch count is 0."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.spmv_ell import spmv_ell_cuda

    for b, h, h_kv, sq, sk, d, dtype, causal in ATTN_SHAPES:
        dt = getattr(torch, dtype)
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((b, h_kv, sk, d), generator=gen, device=dev).to(dt) for _ in "kv")
        got = flash_attention_cuda(q, k, v, causal=causal)
        err, share = attn_error(got, q, k, v, causal)
        tol = ATTN_TOL[dtype]
        check(bool(torch.isfinite(got).all()) and got.dtype == dt and share <= 1.0,
              f"flash_attention {(b, h, h_kv, sq, sk, d, dtype, causal)}: max err {err}, "
              f"{share:.3f} of the tolerance {tol}")
        if causal and sq > sk:
            check(bool((got[:, :, :sq - sk] == 0).all()),
                  "flash_attention: a row with no visible key is not 0")
        say(f"phase kernels: flash_attention ok at (B,H,H_kv,S_q,S_k,D)="
            f"{(b, h, h_kv, sq, sk, d)} {dtype} causal={causal}, max err {err:.2e}, "
            f"{share:.3f} of the tolerance {tol}")
        del q, k, v, got
    torch.cuda.empty_cache()

    rec = None
    for b, r, k, n in ELL_SHAPES:
        idx, valid, x = ell_inputs(dev, gen, b, r, k, n)
        got, want = spmv_ell_cuda(idx, valid, x), ref.spmv_ell_ref(idx, valid, x)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL),
              f"spmv_ell {(b, r, k, n)} vs plain: max err {err}")
        say(f"phase kernels: spmv_ell ok at (B,R,K,N)={(b, r, k, n)}, max err {err:.2e}")
        if rec is None:
            nnz = int(valid.sum())
            rec = record(
                "spmv_ell", 0, err,
                cuda_ms(lambda: spmv_ell_cuda(idx, valid, x), 20),
                cuda_ms(lambda: ref.spmv_ell_ref(idx, valid, x), 3),
                idx.numel() * 4 + valid.numel() + nnz * 4 + b * r * 4, float(nnz), None)
            say(f"  spmv_ell: {nnz} valid entries of {idx.numel()}; no path calls it "
                f"(launches 0)")
        del idx, valid, x, got, want
    torch.cuda.empty_cache()
    return rec


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs an attention head computes: suffix-aligned causal
    row i sees min(S_k, max(0, i + S_k - S_q + 1)) keys."""
    if not causal:
        return sq * sk
    return int(np.clip(np.arange(sq) + sk - sq + 1, 0, sk).sum())


def phase_attn_bwd(dev, gen) -> dict:
    """flash_attention's backward against its plain version at BWD_SHAPES,
    each gradient per tensor, twice for the same bits; the forward's lse on
    both routes against the plain version's.  Times the backward on the
    first shape beside its plain version, SDPA's backward (the one-call
    yardstick; its forward excluded) and its bound, and its dK/dV and dQ
    kernels apart under the profiler.  Returns what the backward's record
    needs but its launches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda

    timing = None
    for shape in BWD_SHAPES:
        b, h, h_kv, sq, sk, d, dtype, causal = shape
        dt = getattr(torch, dtype)
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((b, h_kv, sk, d), generator=gen, device=dev).to(dt) for _ in "kv")
        dout = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
        out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        w_out, w_lse = ref.attention_fwd_ref(q.float(), k.float(), v.float(), causal=causal)
        empty = torch.isinf(w_lse)
        check(torch.equal(torch.isinf(lse), empty) and bool((lse[empty] > 0).all())
              and bool(torch.isfinite(lse[~empty]).all()),
              f"flash_attention {shape}: lse is +inf on other rows than the plain version's")
        lse_err = float((lse[~empty] - w_lse[~empty]).abs().max()) if (~empty).any() else 0.0
        check(torch.allclose(lse[~empty], w_lse[~empty], **LSE_TOL),
              f"flash_attention {shape}: lse max err {lse_err} beyond {LSE_TOL}")
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)
        want = ref.attention_bwd_ref(q.float(), k.float(), v.float(), w_out, w_lse,
                                     dout.float(), causal=causal)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash_attention_bwd {shape}: two runs gave different bits")
        errs, rels = [], []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == dt and bool(torch.isfinite(g).all()),
                  f"flash_attention_bwd {shape}: {name} not finite {dtype}")
            errs.append(float((g.float() - w).abs().max()))
            rels.append(float((g.float() - w).norm() / w.norm().clamp_min(1e-30)))
            if dtype == "float32":
                check(torch.allclose(g, w, **LM_TOL),
                      f"flash_attention_bwd {shape}: {name} max err {errs[-1]} beyond {LM_TOL}")
            else:
                check(rels[-1] <= BWD_BF16_REL, f"flash_attention_bwd {shape}: {name} relative "
                      f"L2 error {rels[-1]} > {BWD_BF16_REL}")
        if causal and sq > sk:
            check(bool((got[0][:, :, :sq - sk] == 0).all()),
                  "flash_attention_bwd: dq of a row with no visible key is not 0")
        say(f"phase kernels backward: {shape} ok, dq dk dv max err "
            f"{[f'{e:.2e}' for e in errs]}, relative L2 {[f'{r:.2e}' for r in rels]} "
            f"({'LM_TOL' if dtype == 'float32' else f'limit {BWD_BF16_REL}'}); lse max err "
            f"{lse_err:.2e}, {int(empty.sum())} rows +inf; the same bits twice")
        if timing is None:
            args = (q, k, v, out, lse, dout)
            qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
            # S_q = S_k, so SDPA's top-left causal mask equals the suffix-aligned one
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
            library = cuda_ms(lambda: torch.autograd.grad(o, (qs, ks, vs), dout,
                                                          retain_graph=True), 5)
            del o, qs, ks, vs, want, again
            torch.cuda.empty_cache()
            pairs = b * h * visible_pairs(sq, sk, causal)
            timing = dict(
                err=max(errs), ms=cuda_ms(lambda: flash_attention_bwd_cuda(*args, causal=causal), 3),
                plain_ms=cuda_ms(lambda: ref.attention_bwd_ref(*args, causal=causal), 1),
                library_ms=library,
                # q, k, v, out, dout read and dq, dk, dv written once, lse read once
                nbytes=(4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * q.element_size()
                + lse.numel() * 4,
                ops=5 * 2.0 * d * pairs)       # five products of 2 D flops a visible pair
            fwd = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), 10)
            fwd_lse = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                           return_lse=True), 10)
            reps = 5
            _, _, busy, top = device_profile(
                lambda: [flash_attention_bwd_cuda(*args, causal=causal) for _ in range(reps)])
            parts = "not measured" if busy is None else ", ".join(
                f"{part} {sum(t for key, t in top if tag in key) / reps:.4f} ms"
                for part, tag in (("(a) delta", "delta_kernel"), ("(b) dK/dV", "dkdv_kernel"),
                                  ("(c) dQ", "dq_kernel")))
            say(f"  flash_attention_bwd at {shape}: {timing['ms']:.3f} ms ({parts}; profiler), "
                f"plain {timing['plain_ms']:.2f} ms, SDPA backward {library:.3f} ms, "
                f"{timing['ops'] / timing['ms'] / 1e9:.1f} TFLOP/s of the five products, "
                f"{timing['ops'] * 7 / 5 / timing['ms'] / 1e9:.1f} of the seven done; "
                f"the forward {fwd:.4f} ms, with lse {fwd_lse:.4f} ms")
        del q, k, v, dout, out, lse, w_out, w_lse, got
        torch.cuda.empty_cache()
    return timing


def csr_matrix(g):
    import scipy.sparse as sp

    return sp.csr_matrix((np.ones(g.m, np.float64), g.indices, g.indptr), shape=(g.n, g.n))


def tile_fill(store) -> float:
    """Share of the materialized tiles' T² entries that lie inside their
    blocks (the rest is padding up to tile_dim)."""
    w = np.diff(store.layout.cuts)
    i, j = np.divmod(store.tile_block_ids.astype(np.int64), store.p)
    return float((w[i] * w[j]).sum() / (store.tile_block_ids.size * store.tile_dim ** 2))


def pagerank64(g, iterations):
    """PageRank's formula in float64 over ``iterations`` iterations."""
    at = csr_matrix(g).T.tocsr()
    deg = g.degrees
    inv = 1.0 / np.maximum(deg, 1)
    dangling = deg == 0
    x = np.full(g.n, 1.0 / g.n)
    for _ in range(iterations):
        x = 0.15 / g.n + 0.85 * (at @ (x * inv) + x[dangling].sum() / g.n)
    return x


def bfs64(g, src):
    """scipy's unweighted distances from ``src``, INT_MAX where unreached."""
    import scipy.sparse.csgraph as csgraph

    want = csgraph.shortest_path(csr_matrix(g), method="D", unweighted=True, indices=src)
    return np.where(np.isinf(want), INT_MAX, want).astype(np.int64)


def tc64(dag) -> int:
    """scipy's exact triangle count of a DAG: the sum of (A @ A) ∘ A."""
    import scipy.sparse as sp

    a = sp.csr_matrix((np.ones(dag.m, np.int64), dag.indices, dag.indptr), shape=(dag.n, dag.n))
    return int((a @ a).multiply(a).sum())


def phase_pagerank(dev, store):
    import torch
    from repro_torch.algorithms import pagerank_algorithm
    from repro_torch.core import compile_plan
    from repro_torch.kernels import ref, registry
    from repro_torch.kernels.spmv_tiles import spmv_tiles_cuda

    cfg = PAGERANK
    t0 = time.perf_counter()
    plan = compile_plan(pagerank_algorithm(), store, device=dev, tile_dim=cfg["tile_dim"],
                        dense_density=cfg["dense_density"])
    st = plan.schedule.stats
    nd, t = plan.context.tiles.shape[0], cfg["tile_dim"]
    say(f"phase pagerank: schedule + device copy {time.perf_counter() - t0:.1f} s, "
        f"tasks {st['num_tasks']}, dense tasks {st['dense_tasks']}, tiles {nd} "
        f"({nd * t * t * 4 / 1e9:.2f} GB f32, {tile_fill(store):.3f} inside the blocks), "
        f"dense weight {st['dense_weight_frac']:.3f}")
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launch_counts()
    res = plan.run()
    launches = registry.launch_counts()
    check(launches["spmv_tiles"] == res.iterations,
          f"spmv_tiles launches {launches['spmv_tiles']} != iterations {res.iterations}")
    say(f"phase pagerank: {res.iterations} iterations in {res.seconds * 1e3:.1f} ms "
        f"({res.seconds * 1e3 / res.iterations:.2f} ms per iteration, host clock), "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
        f"launches {launches}")

    g = store.graph
    l1 = float(np.abs(res.result.astype(np.float64) - pagerank64(g, res.iterations)).sum())
    check(bool(np.isfinite(res.result).all()) and res.result.shape == (g.n,),
          "pagerank result shape/finite")
    check(l1 <= PAGERANK_L1_TOL, f"pagerank L1 distance to float64 {l1} > {PAGERANK_L1_TOL}")
    say(f"phase pagerank: L1 distance to float64 scipy {l1:.3e} (limit {PAGERANK_L1_TOL}), "
        f"rank sum {float(res.result.sum()):.6f}")

    _, wall, busy, top = device_profile(plan.run)
    if busy is None:
        say(f"phase pagerank: device time not measured ({top})")
    else:
        say(f"phase pagerank: profiled run {wall:.1f} ms wall, device busy {busy:.1f} ms "
            f"({busy / res.iterations:.3f} ms per iteration, idle share "
            f"{1 - busy / wall:.3f}); busiest kernels {top}")
    no_recovery(plan, "pagerank")
    # phase stream's and phase hetero's reference: in-core, cut to
    # STREAM_PR_ITERS (= HETERO_PR_ITERS) iterations
    short = compile_plan(pagerank_algorithm(max_iters=HETERO_PR_ITERS), store, plan.schedule,
                         device=dev, tile_dim=cfg["tile_dim"],
                         dense_density=cfg["dense_density"])
    pr_short = short.run()
    no_recovery(short, "pagerank short")
    check(pr_short.iterations == HETERO_PR_ITERS,
          f"pagerank short: {pr_short.iterations} iterations != {HETERO_PR_ITERS}")
    # phase mesh's reference: in-core, cut to MESH_PR_ITERS iterations
    three = compile_plan(pagerank_algorithm(max_iters=MESH_PR_ITERS), store, plan.schedule,
                         device=dev, tile_dim=cfg["tile_dim"],
                         dense_density=cfg["dense_density"])
    pr_three = three.run()
    no_recovery(three, "pagerank three")
    check(pr_three.iterations == MESH_PR_ITERS,
          f"pagerank three: {pr_three.iterations} iterations != {MESH_PR_ITERS}")
    del short, three

    # time the kernel on the inputs the last iteration gave it
    ctx = plan.context
    contrib = res.state["rank"] * ctx.extras["inv_deg"]
    cols = torch.arange(t, device=dev)
    xs = torch.cat([contrib, contrib.new_zeros(t)])[ctx.tile_row_start[:, None] + cols]
    tiles = ctx.tiles
    extents = (ctx.tile_rows, ctx.tile_cols)
    err = check_spmv(tiles, xs, extents, "main-path inputs")
    # inside the block rectangles: each rectangle's elements and the x
    # below its rows once, ys written whole, the extents read
    area = float((ctx.tile_rows.double() * ctx.tile_cols.double()).sum())
    x_read = float(ctx.tile_rows.double().sum()) * xs.element_size()
    rec = record(
        "spmv_tiles", launches["spmv_tiles"], err,
        cuda_ms(lambda: spmv_tiles_cuda(tiles, xs, extents), 20),
        cuda_ms(lambda: ref.spmv_tiles_ref(tiles, xs), 3),
        area * tiles.element_size() + x_read + nd * t * 4 + 2 * nd * 4, 2.0 * area,
        cuda_ms(lambda: torch.einsum("brc,br->bc", tiles, xs), 5))
    old_bound = bound(nd * t * t * 4 + 2 * nd * t * 4, 2.0 * nd * t * t)
    whole_ms = cuda_ms(lambda: spmv_tiles_cuda(tiles, xs), 20)
    rows, cols = ctx.tile_rows.double(), ctx.tile_cols.double()
    corr = float(torch.corrcoef(torch.stack([rows, cols]))[0, 1])
    say(f"  spmv_tiles: {area / (nd * t * t):.4f} of the tile elements inside the "
        f"rectangles; rows/cols median {float(rows.median()):.0f}/{float(cols.median()):.0f}, "
        f"correlation {corr:.3f}, largest rectangle {float((rows * cols).max()):.0f} elements; "
        f"whole-tile bound {old_bound[0]:.4f} ms ({old_bound[1]}); the kernel without extents "
        f"{whole_ms:.4f} ms")
    return plan, rec, res, pr_short.result, pr_three.result


def frontier_needed(f, want, rows) -> float:
    """Tile elements the frontier columns ``f`` need, given the kernel's
    result ``want`` (both (nd, T), or (Q, nd, T) for a batch over shared
    tiles): for each tile row below ``rows``, the union over the queries
    of each query's frontier columns up to its first hit (all of them
    where it has none), so that a batch counts each element once."""
    import torch

    if f.dim() == 2:
        f, want = f[None], want[None]
    t = f.shape[-1]
    cols = torch.arange(t, device=f.device)
    total = 0
    for b in range(0, f.shape[1], 16):        # 16 tiles at a time bound the masks
        fb, wb = f[:, b:b + 16, None, :], want[:, b:b + 16, :, None].long()
        need = (fb & (cols <= wb)).any(0)     # (tiles, rows, cols); INT_MAX: all
        need &= cols[None, :, None] < rows[b:b + 16, None, None]
        total += int(need.sum())
    return float(total)


def phase_bfs(dev, store, schedule):
    import torch
    from repro_torch.algorithms import bfs_algorithm
    from repro_torch.core import compile_plan
    from repro_torch.kernels import ref, registry
    from repro_torch.kernels.frontier_tiles import frontier_tiles_cuda

    g = store.graph
    src = int(np.argmax(store.degrees))
    registry.reset_launch_counts()
    plans = {d: compile_plan(bfs_algorithm(src), store, schedule, device=dev, direction=d)
             for d in ("push", "pull", "auto")}
    runs = {d: plan.run() for d, plan in plans.items()}
    launches = registry.launch_counts()
    for d, plan in plans.items():
        no_recovery(plan, f"bfs {d}")
    for d, r in runs.items():
        say(f"phase bfs: {d} {r.iterations} levels in {r.seconds * 1e3:.1f} ms, "
            f"decisions {r.schedule_stats['direction']['decisions']}")
    check(launches["frontier_tiles"] > 0, "frontier_tiles never launched on the BFS path")
    decisions = runs["auto"].schedule_stats["direction"]["decisions"]
    check("pull" in decisions, "auto BFS took no pull iteration")

    dist, parent = runs["push"].result["dist"], runs["push"].result["parent"]
    for d in ("pull", "auto"):
        check(np.array_equal(runs[d].result["dist"], dist)
              and np.array_equal(runs[d].result["parent"], parent), f"bfs {d} != push")
    check(np.array_equal(dist.astype(np.int64), bfs64(g, src)), "bfs dist != scipy distances")
    v = np.flatnonzero((dist > 0) & (dist != INT_MAX))
    pv = parent[v].astype(np.int64)
    keys = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees) * g.n + g.indices
    pos = np.searchsorted(keys, pv * g.n + v).clip(max=keys.size - 1)
    check(bool((keys[pos] == pv * g.n + v).all()), "a bfs parent is not a neighbour")
    check(bool((dist[pv] == dist[v] - 1).all()), "a bfs parent is not one level closer")
    say(f"phase bfs: dist equals scipy on {int((dist != INT_MAX).sum())} reached vertices, "
        f"parents valid, directions agree, launches {launches}")

    # time the kernel on the largest frontier a pull level probed
    pulls = [it for it, d in enumerate(decisions) if d == "pull"]
    level = max(pulls, key=lambda it: int((dist == it).sum()))
    ctx = plans["auto"].context
    t = ctx.tile_dim
    frontier = torch.from_numpy(dist == level).to(dev)
    cols = torch.arange(t, device=dev)
    fcols = torch.cat([frontier, frontier.new_zeros(t)])[ctx.tile_col_start[:, None] + cols]
    tiles = ctx.tiles
    extents = (ctx.tile_rows, ctx.tile_cols)
    got = frontier_tiles_cuda(tiles, fcols, extents)
    want = ref.frontier_tiles_ref(tiles, fcols)
    check(torch.equal(got, want), "frontier_tiles main-path inputs")
    check(torch.equal(frontier_tiles_cuda(tiles, fcols), want),
          "frontier_tiles main-path inputs, whole tiles")
    nd = tiles.shape[0]
    # over whole tiles, then inside the block rectangles
    old_needed = frontier_needed(fcols, want, torch.full((nd,), t, device=dev))
    old_bound = bound(old_needed * 4 + nd * t * (1 + 4), old_needed)
    inside = fcols & (cols[None, :] < ctx.tile_cols[:, None])
    new_needed = frontier_needed(inside, want, ctx.tile_rows)
    rec = record(
        "frontier_tiles", launches["frontier_tiles"],
        float((got.long() - want.long()).abs().max()),
        cuda_ms(lambda: frontier_tiles_cuda(tiles, fcols, extents), 20),
        cuda_ms(lambda: ref.frontier_tiles_ref(tiles, fcols), 3),
        new_needed * 4 + float(ctx.tile_cols.sum()) + nd * t * 4 + 2 * nd * 4,
        new_needed, None)
    whole_ms = cuda_ms(lambda: frontier_tiles_cuda(tiles, fcols), 20)
    say(f"  frontier_tiles timed on level {level}: frontier {int(frontier.sum())} vertices; "
        f"elements needed {new_needed:.0f} inside the rectangles, {old_needed:.0f} over whole "
        f"tiles; whole-tile bound {old_bound[0]:.4f} ms ({old_bound[1]}); the kernel "
        f"without extents {whole_ms:.4f} ms")
    return rec, runs["auto"]


def phase_tc(dev):
    import torch
    from repro_torch.algorithms import tc_algorithm
    from repro_torch.algorithms.tc import orient_dag
    from repro_torch.core import build_block_store, compile_plan, rmat
    from repro_torch.kernels import ref, registry
    from repro_torch.kernels.tc_tiles import tc_tiles_cuda

    cfg = TC
    t0 = time.perf_counter()
    dag = orient_dag(rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"]))
    store = build_block_store(dag, cfg["p"])
    plan = compile_plan(tc_algorithm(), store, device=dev, tile_dim=cfg["tile_dim"],
                        dense_density=cfg["dense_density"])
    idx, tiles = plan.context.extras["tc_tiles_idx"], plan.context.tiles
    st = plan.schedule.stats
    say(f"phase tc: host build {time.perf_counter() - t0:.1f} s, n {dag.n}, arcs {dag.m}, "
        f"triples {st['num_tasks']}, dense triples {idx.shape[0]} over {tiles.shape[0]} tiles "
        f"({tile_fill(store):.3f} inside the blocks)")
    registry.reset_launch_counts()
    res = plan.run()
    launches = registry.launch_counts()
    no_recovery(plan, "tc")
    check(launches["tc_tiles"] > 0, "tc_tiles never launched on the TC path")
    want = tc64(dag)
    check(res.result == want, f"triangle count {res.result} != scipy {want}")
    say(f"phase tc: {res.result} triangles in {res.seconds * 1e3:.1f} ms (scipy {want}), "
        f"launches {launches}")

    ctx = plan.context
    extents = (ctx.tile_rows, ctx.tile_cols)
    got, plain = int(tc_tiles_cuda(tiles, idx, extents)), int(ref.tc_tiles_idx_ref(tiles, idx))
    check(got == plain, f"tc_tiles main-path inputs: kernel {got} vs plain {plain}")
    whole = int(tc_tiles_cuda(tiles, idx))
    check(whole == plain, f"tc_tiles main-path inputs, whole tiles: kernel {whole} vs {plain}")
    nd, t = tiles.shape[0], tiles.shape[1]
    live = idx[idx[:, 0] >= 0].long()
    nnz = tiles.sum(dim=(1, 2)).double()
    nnz_ij = float(nnz[idx[:, 0].long()].sum())
    # over whole tiles: every tile byte once, 2T flops per entry of
    # A_ij at the float32 CUDA-core rate
    old_bound = bound(nd * t * t * 4 + idx.numel() * 4 + 8, 2.0 * t * nnz_ij)
    # inside the rectangles: each distinct tile's rectangle once, and
    # 2 * cols[ik] flops per entry of A_ij at the TF32 tensor-core rate
    used = torch.unique(live.reshape(-1))
    area = float((ctx.tile_rows[used].double() * ctx.tile_cols[used].double()).sum())
    new_bytes = area * tiles.element_size() + idx.numel() * 4 + 2 * nd * 4 + 8
    new_ops = 2.0 * float((ctx.tile_cols[live[:, 1]].double() * nnz[live[:, 0]]).sum())

    def library():
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(0, idx.shape[0], ref.CHUNK):
            rows = idx[s:s + ref.CHUNK].long()
            w = torch.einsum("brc,bsc->brs", tiles[rows[:, 1]], tiles[rows[:, 2]])
            total += (w * tiles[rows[:, 0]]).sum()
        return total

    rec = record(
        "tc_tiles", launches["tc_tiles"], abs(got - plain),
        cuda_ms(lambda: tc_tiles_cuda(tiles, idx, extents), 5),
        cuda_ms(lambda: ref.tc_tiles_idx_ref(tiles, idx), 2),
        new_bytes, new_ops, cuda_ms(library, 2), rate=TF32_TC_FLOPS)
    whole_ms = cuda_ms(lambda: tc_tiles_cuda(tiles, idx), 5)
    say(f"  tc_tiles: dense-path count {got} of {res.result}; {used.numel()} distinct tiles, "
        f"{float(nnz.sum()) / nd:.1f} entries per tile, rectangles {area * 4 / 1e9:.3f} GB, "
        f"{new_ops / 1e9:.2f} GFLOP; whole-tile bound "
        f"{old_bound[0]:.4f} ms ({old_bound[1]}); the kernel without extents {whole_ms:.4f} ms")
    return rec, store, plan.schedule, res


def same_partition(a, b) -> bool:
    """Two label vectors define the same partition of the vertices."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    pairs = np.unique(a * (int(b.max()) + 1) + b).size
    return np.unique(a).size == np.unique(b).size == pairs


def kcore64(g, k):
    """Peeling oracle: drop vertices with fewer than ``k`` alive
    neighbours until none is dropped."""
    a = csr_matrix(g)
    alive = np.ones(g.n, bool)
    while True:
        new = alive & (a @ alive.astype(np.float64) >= k)
        if np.array_equal(new, alive):
            return alive
        alive = new


def hits64(g, iterations):
    """HITS' phase-split power iteration in float64 (even: authorities,
    odd: hubs), as the algorithm runs it."""
    a = csr_matrix(g)
    at = a.T.tocsr()
    hub = auth = np.full(g.n, 1.0 / np.sqrt(g.n))
    for it in range(iterations):
        if it % 2 == 0:
            acc = at @ hub
            auth = acc / max(np.linalg.norm(acc), 1e-12)
        else:
            acc = a @ auth
            hub = acc / max(np.linalg.norm(acc), 1e-12)
    return hub, auth


def phase_algorithms(dev, store):
    """SV, Afforest, k-core and HITS in-core on the PageRank store, each
    against scipy or a float64 oracle.  Returns Afforest's labels (the
    streamed CC run is held against them)."""
    import scipy.sparse.csgraph as csgraph
    from repro_torch import obs
    from repro_torch.algorithms import (
        afforest_algorithm, hits_algorithm, kcore_algorithm, sv_algorithm,
    )
    from repro_torch.core import compile_plan

    g = store.graph
    t0 = time.perf_counter()
    ncomp, want = csgraph.connected_components(csr_matrix(g), directed=False)
    say(f"phase algorithms: scipy {ncomp} components in {time.perf_counter() - t0:.1f} s")
    rounds = obs.metrics.counter("pointer_jump.rounds")
    labels = {}
    for name, alg in (("sv", sv_algorithm()), ("afforest", afforest_algorithm())):
        r0 = rounds.value
        plan = compile_plan(alg, store, device=dev)
        res = plan.run()
        no_recovery(plan, name)
        check(same_partition(res.result, want), f"{name} components != scipy's")
        labels[name] = res.result
        cc_ms = res.seconds * 1e3 / res.iterations
        say(f"phase algorithms: {name} {res.iterations} iterations in "
            f"{res.seconds * 1e3:.1f} ms (host clock), {int(rounds.value - r0)} pointer-jump "
            f"sync rounds, components equal scipy's ({ncomp})")
    res = compile_plan(kcore_algorithm(KCORE_K), store, device=dev, mode="sparse_only").run()
    core = kcore64(g, KCORE_K)
    check(np.array_equal(res.result, core), f"{KCORE_K}-core != numpy peeling")
    say(f"phase algorithms: {KCORE_K}-core {res.iterations} iterations in "
        f"{res.seconds * 1e3:.1f} ms (host clock), {int(core.sum())} vertices, equal to "
        f"numpy peeling")
    res = compile_plan(hits_algorithm(), store, device=dev, mode="sparse_only").run()
    hub, auth = hits64(g, res.iterations)
    errs = [float(np.abs(res.result[k].astype(np.float64) - w).sum() / np.abs(w).sum())
            for k, w in (("hub", hub), ("auth", auth))]
    check(all(np.isfinite(res.result[k]).all() for k in ("hub", "auth")), "hits finite")
    check(max(errs) <= HITS_REL_L1_TOL,
          f"hits relative L1 to float64 {errs} > {HITS_REL_L1_TOL}")
    say(f"phase algorithms: hits {res.iterations} iterations in {res.seconds * 1e3:.1f} ms "
        f"(host clock), relative L1 to float64 scipy: hub {errs[0]:.2e}, auth {errs[1]:.2e} "
        f"(limit {HITS_REL_L1_TOL})")
    return labels["afforest"], cc_ms


def pinned_h2d_rate(dev) -> float:
    """Bytes per second of one large copy from pinned host memory."""
    import torch

    host = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    out = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: out.copy_(host, non_blocking=True), 5)
    return H2D_PROBE_BYTES / (ms / 1e3)


def quarter_budget(alg, store, schedule, split):
    """The schedule's total task footprint (as the streamed plan prices
    it) over ``split``."""
    from repro_torch.core import task_footprints
    from repro_torch.core.direction import workspace_kernels

    fp = task_footprints(store, schedule,
                         workspace_kernel=workspace_kernels(alg, "auto"),
                         stage_csr=alg.metadata.get("csr") == "slice")
    return int(fp.sum()) // split


def no_recovery(plan, what: str) -> None:
    """A fault-free plan detected no failure, demoted no wave and kept its
    host lane: nothing fell back to the host's plain kernels."""
    r = plan._resil
    check(r.detected == 0 and r.demotions == 0 and r.host_failovers == 0
          and not any(a["action"] == "host_disable" for a in r.actions),
          f"{what}: a fault-free run recovered from a failure: {r.snapshot()}")


def hetero_line(het) -> str:
    return (f"host_fraction {het['host_fraction']!r} resolved to split "
            f"{het['resolved_split']:.4f}: {het['host_tasks']} host tasks in "
            f"{het['host_units']} units ({het['host_tasks_executed']} executed), "
            f"{het['device_tasks']} device tasks, refreshes {het['refreshes']}, host ratio "
            f"{het['host_ratio']:.4g} (measured {het['host_ratio_measured']}), makespan "
            f"device {het['makespan']['device_s']:.3f} s, host {het['makespan']['host_s']:.3f} s")


def wave_context(plan, w):
    """Wave ``w``'s context on the card, staged as the run stages it."""
    recipe = plan._slabs[w]
    staged = plan._put_slab(plan._assemble_runtime(recipe, wave=w), wave=w)
    return plan._wave_context(staged, recipe.nd)


def stream_run(dev, name, alg, store, budget, rate, incore_ms, **kw):
    """Compile and run one streamed plan; checks the budget and memory
    invariants and that nothing was recovered, and prints the phase line
    and what the host lane resolved to.  Returns (plan, result, launches,
    summary)."""
    import torch
    from repro_torch.core import compile_plan
    from repro_torch.kernels import registry

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    plan = compile_plan(alg, store, device=dev, memory_budget=budget, **kw)
    build_s = time.perf_counter() - t0
    registry.reset_launch_counts()
    res = plan.run()
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    st = res.schedule_stats["streaming"]
    check(all(b + w <= budget for b, w in zip(st["bytes_per_wave"], st["workspace_per_wave"])),
          f"stream {name}: a wave's staged bytes + workspace exceed the budget {budget}")
    limit = plan.resident_device_bytes + (plan.pipeline_depth + 1) * budget
    check(peak <= limit, f"stream {name}: max_memory_allocated {peak} > {limit}")
    no_recovery(plan, f"stream {name}")
    per_iter = sum(st["bytes_per_wave"])
    steady = (st["overlapped_wall_seconds"] / st["overlapped_iterations"] * 1e3
              if st["overlapped_iterations"] else float("nan"))
    h2d_rate = st["h2d_bytes"] / st["h2d_seconds"] if st["h2d_seconds"] else float("nan")
    say(f"phase stream {name}: budget {budget / 1e9:.3f} GB, {st['num_waves']} waves "
        f"(planning {build_s:.1f} s), {per_iter / 1e9:.3f} GB staged per iteration, "
        f"{res.iterations} iterations in {res.seconds:.2f} s: "
        f"{res.seconds * 1e3 / res.iterations:.1f} ms per iteration (host clock; steady "
        f"overlapped {steady:.1f} ms) vs in-core {incore_ms:.1f} ms; copies "
        f"{st['h2d_bytes'] / 1e9:.2f} GB in {st['h2d_seconds'] * 1e3:.1f} ms on the copy stream "
        f"({h2d_rate / 1e9:.1f} GB/s; one pinned {H2D_PROBE_BYTES >> 20} MiB copy "
        f"{rate / 1e9:.1f} GB/s), bound {per_iter / rate * 1e3:.1f} ms per iteration; "
        f"device_put host time {st['phase_seconds']['device_put'] * 1e3:.1f} ms; stall "
        f"{st['stall_seconds'] * 1e3:.1f} ms, host_stage_overlap "
        f"{st['host_stage_overlap']:.3f}, overlap_efficiency {st['overlap_efficiency']:.3f}; "
        f"max_memory_allocated {peak / 1e9:.2f} GB (limit {limit / 1e9:.2f}); arena "
        f"{st['arena_bytes'] / 1e9:.2f} GB pinned; launches {launches}")
    say(f"phase stream {name}: {hetero_line(res.schedule_stats['hetero'])}")
    summary = dict(budget=budget, per_iter=per_iter, steady=steady, stall=st["stall_seconds"],
                   ms=res.seconds * 1e3 / res.iterations,
                   overlap=st["host_stage_overlap"], waves=st["num_waves"])
    return plan, res, launches, summary


def phase_stream(dev, store, schedule, pagerank, pr_short, bfs, cc, cc_ms):
    """PageRank (STREAM_PR_ITERS iterations), BFS (auto) and CC streamed on
    the PageRank store under a budget of a quarter of their total
    footprint, each held against its in-core run (PageRank's cut alike,
    ``pr_short``); each tile kernel also timed on a wave slab."""
    import torch
    from repro_torch.algorithms import afforest_algorithm, bfs_algorithm, pagerank_algorithm
    from repro_torch.core import build_schedule
    from repro_torch.kernels.frontier_tiles import frontier_tiles_cuda
    from repro_torch.kernels.spmv_tiles import spmv_tiles_cuda

    cfg = PAGERANK
    kw = dict(tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    rate = pinned_h2d_rate(dev)
    out = {}
    runs = {}

    alg = pagerank_algorithm(max_iters=STREAM_PR_ITERS)
    budget = quarter_budget(alg, store, schedule, STREAM_SPLIT)
    plan, res, launches, runs["pagerank"] = stream_run(
        dev, "pagerank", alg, store, budget, rate,
        pagerank.seconds * 1e3 / pagerank.iterations, **kw)
    check(plan.num_waves >= 4, f"stream pagerank: {plan.num_waves} waves < 4")
    check(launches["spmv_tiles"] > 0, "stream pagerank: spmv_tiles never launched")
    check(res.iterations == STREAM_PR_ITERS,
          f"stream pagerank: {res.iterations} iterations != {STREAM_PR_ITERS}")
    g = store.graph
    l1 = float(np.abs(res.result.astype(np.float64) - pagerank64(g, res.iterations)).sum())
    check(l1 <= PAGERANK_L1_TOL, f"stream pagerank L1 to float64 {l1} > {PAGERANK_L1_TOL}")
    say(f"phase stream pagerank: L1 distance to float64 scipy {l1:.3e} (limit "
        f"{PAGERANK_L1_TOL}), to the in-core ranks "
        f"{float(np.abs(res.result - pr_short).sum()):.3e} (in-core cut to "
        f"{STREAM_PR_ITERS} iterations)")
    w = max(range(plan.num_waves), key=lambda i: plan._slabs[i].nd)
    ctx = wave_context(plan, w)
    t = ctx.tile_dim
    cols = torch.arange(t, device=dev)
    contrib = res.state["rank"] * ctx.extras["inv_deg"]
    xs = torch.cat([contrib, contrib.new_zeros(t)])[ctx.tile_row_start[:, None] + cols]
    out["spmv_tiles"] = (launches["spmv_tiles"], cuda_ms(
        lambda: spmv_tiles_cuda(ctx.tiles, xs, (ctx.tile_rows, ctx.tile_cols)), 20),
        ctx.tiles.shape[0], plan._slabs[w].nd)
    del plan, ctx, xs

    # BFS routes the same tasks to the tiles as PageRank (same estimate,
    # same cut-offs), so PageRank's schedule prices it
    src = int(np.argmax(store.degrees))
    alg = bfs_algorithm(src)
    budget = quarter_budget(alg, store, schedule, STREAM_SPLIT)
    plan, res, launches, runs["bfs"] = stream_run(
        dev, "bfs", alg, store, budget, rate, bfs.seconds * 1e3 / bfs.iterations,
        direction="auto", **kw)
    check(plan.num_waves >= 4, f"stream bfs: {plan.num_waves} waves < 4")
    for k in ("parent", "dist"):
        check(np.array_equal(res.result[k], bfs.result[k]), f"stream bfs {k} != in-core")
    decisions = res.schedule_stats["direction"]["decisions"]
    check("pull" in decisions, "stream bfs took no pull level")
    check(launches["frontier_tiles"] > 0, "stream bfs: frontier_tiles never launched")
    say(f"phase stream bfs: parent and dist equal in-core, decisions {decisions}")
    w = max(range(plan.num_waves), key=lambda i: plan._slabs[i].nd)
    ctx = wave_context(plan, w)
    dist = res.result["dist"]
    level = max(range(res.iterations), key=lambda it: int((dist == it).sum()))
    frontier = torch.from_numpy(dist == level).to(dev)
    fcols = torch.cat([frontier, frontier.new_zeros(t)])[ctx.tile_col_start[:, None] + cols]
    out["frontier_tiles"] = (launches["frontier_tiles"], cuda_ms(
        lambda: frontier_tiles_cuda(ctx.tiles, fcols, (ctx.tile_rows, ctx.tile_cols)), 20),
        ctx.tiles.shape[0], plan._slabs[w].nd)
    del plan, ctx, fcols

    alg = afforest_algorithm()
    sched = build_schedule(alg, store)
    budget = quarter_budget(alg, store, sched, STREAM_SPLIT)
    plan, res, _, runs["cc"] = stream_run(dev, "cc", alg, store, budget, rate, cc_ms)
    check(plan.num_waves >= 4, f"stream cc: {plan.num_waves} waves < 4")
    check(np.array_equal(res.result, cc), "stream cc labels != in-core")
    say("phase stream cc: labels equal in-core")
    del plan
    return out, rate, runs


def hetero_run(dev, name, alg, store, base, rate, incore_ms, **kw):
    """One streamed run with the host lane at HOST_FRACTION on a phase
    stream budget: stream_run's checks, then the split, staged bytes and
    times printed beside the device-only run's.  Returns (result, launches)."""
    import torch

    plan, res, launches, info = stream_run(dev, f"hetero {name}", alg, store, base["budget"],
                                           rate, incore_ms, host_fraction=HOST_FRACTION, **kw)
    het = res.schedule_stats["hetero"]
    check(het["enabled"] and het["host_tasks"] > 0 and het["host_tasks_executed"] > 0,
          f"hetero {name}: the host lane ran no task: {het}")
    check(het["resolved_split"] > 0.0, f"hetero {name}: resolved split 0")
    say(f"phase hetero {name}: {info['waves']} device waves, {het['host_units']} host units, "
        f"{het['host_tasks']} host tasks, resolved_split {het['resolved_split']:.4f}; staged "
        f"{info['per_iter'] / 1e9:.3f} GB per iteration (device-only {base['per_iter'] / 1e9:.3f}); "
        f"{info['ms']:.1f} ms per iteration, steady {info['steady']:.1f} (device-only "
        f"{base['ms']:.1f}, steady {base['steady']:.1f}); makespan device "
        f"{het['makespan']['device_s']:.3f} s, host {het['makespan']['host_s']:.3f} s "
        f"(host busy {het['host_seconds']:.3f} s in all); stall {info['stall'] * 1e3:.1f} ms "
        f"(device-only {base['stall'] * 1e3:.1f}), host_stage_overlap {info['overlap']:.3f} "
        f"(device-only {base['overlap']:.3f}); os.cpu_count() {os.cpu_count()}, "
        f"torch.get_num_threads() {torch.get_num_threads()}, host pool "
        f"{plan._host_lane._pool._max_workers if plan._host_lane else 0} threads")
    plan.close()
    return res, launches


def phase_hetero(dev, store, runs, rate, bfs, cc, cc_ms, pagerank, pr_short):
    """The host lane at HOST_FRACTION beside the card's streamed waves,
    on phase stream's budgets: CC and BFS auto bit for bit against
    in-core, PageRank (cut to HETERO_PR_ITERS iterations) within
    HETERO_PR_RTOL of in-core.  Returns the hetero CC labels."""
    from repro_torch.algorithms import afforest_algorithm, bfs_algorithm, pagerank_algorithm

    cfg = PAGERANK
    kw = dict(tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    res, _ = hetero_run(dev, "cc", afforest_algorithm(), store, runs["cc"], rate, cc_ms,
                        mode="sparse_only")
    check(np.array_equal(res.result, cc), "hetero cc labels != in-core")
    labels = res.result
    say("phase hetero cc: labels equal in-core")

    src = int(np.argmax(store.degrees))
    res, launches = hetero_run(dev, "bfs", bfs_algorithm(src), store, runs["bfs"], rate,
                               bfs.seconds * 1e3 / bfs.iterations, direction="auto", **kw)
    for k in ("parent", "dist"):
        check(np.array_equal(res.result[k], bfs.result[k]), f"hetero bfs {k} != in-core")
    decisions = res.schedule_stats["direction"]["decisions"]
    check(decisions == bfs.schedule_stats["direction"]["decisions"],
          f"hetero bfs decisions {decisions} != in-core")
    say(f"phase hetero bfs: parent, dist and decisions equal in-core ({decisions}); "
        f"frontier_tiles launches {launches['frontier_tiles']}")

    res, launches = hetero_run(dev, "pagerank", pagerank_algorithm(max_iters=HETERO_PR_ITERS),
                               store, runs["pagerank"], rate,
                               pagerank.seconds * 1e3 / pagerank.iterations, **kw)
    check(res.iterations == HETERO_PR_ITERS,
          f"hetero pagerank: {res.iterations} iterations != {HETERO_PR_ITERS}")
    check(launches["spmv_tiles"] > 0, "hetero pagerank: spmv_tiles never launched")
    n = store.n
    err = np.abs(res.result.astype(np.float64) - pr_short)
    rel = float((err / np.maximum(np.abs(pr_short), 1e-30)).max())
    check(bool(np.allclose(res.result, pr_short, rtol=HETERO_PR_RTOL, atol=HETERO_PR_RTOL / n)),
          f"hetero pagerank vs in-core ({HETERO_PR_ITERS} iterations): largest relative "
          f"difference {rel}")
    say(f"phase hetero pagerank: {HETERO_PR_ITERS} iterations within rtol {HETERO_PR_RTOL} "
        f"(atol {HETERO_PR_RTOL}/n) of in-core: largest relative difference {rel:.2e}, L1 "
        f"{float(err.sum()):.3e}; spmv_tiles launches on the device waves "
        f"{launches['spmv_tiles']}")
    return labels


def phase_resilience(dev, store, schedule, runs, bfs, hetero_cc):
    """Faults injected at every seam of a streamed CC run with the host
    lane, recovered to the fault-free labels; BFS auto checkpointed and
    resumed, streamed and in-core; a real OOM classified."""
    import tempfile

    import torch
    from repro_torch.algorithms import afforest_algorithm, bfs_algorithm
    from repro_torch.core import RetryPolicy, compile_plan
    from repro_torch.core.resilience import classify

    cfg = PAGERANK
    kw = dict(tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    t0 = time.perf_counter()
    plan = compile_plan(afforest_algorithm(), store, device=dev, mode="sparse_only",
                        memory_budget=runs["cc"]["budget"], host_fraction=HOST_FRACTION,
                        faults=FAULTS, retry_policy=RetryPolicy(max_retries=FAULT_RETRIES))
    res = plan.run()
    r = res.schedule_stats["resilience"]
    check(np.array_equal(res.result, hetero_cc), "resilience cc labels != fault-free hetero cc")
    check(r["injected"] == 4 and r["retries"] >= 4 and r["oom_repacks"] >= 1,
          f"resilience cc counters: {r}")
    say(f"phase resilience cc: faults {FAULTS!r} recovered in {time.perf_counter() - t0:.1f} s "
        f"(planning included): labels equal the fault-free run; injected {r['injected']}, "
        f"detected {r['detected']}, retries {r['retries']}, oom_repacks {r['oom_repacks']}, "
        f"demotions {r['demotions']}, actions {[a['action'] for a in r['actions']]}; "
        f"{plan.num_waves} waves after the re-pack")
    plan.close()
    del plan

    src = int(np.argmax(store.degrees))
    want = bfs.schedule_stats["direction"]["decisions"]
    for where in ("streamed", "in-core"):
        extra = (dict(memory_budget=runs["bfs"]["budget"]) if where == "streamed"
                 else dict(schedule=schedule))
        with tempfile.TemporaryDirectory(prefix="repro-ckpt-") as d:
            t0 = time.perf_counter()
            plan = compile_plan(bfs_algorithm(src), store, device=dev, direction="auto",
                                checkpoint_every=1, checkpoint_dir=d, **kw, **extra)
            full = plan.run()
            no_recovery(plan, f"resilience bfs {where}")
            check(full.schedule_stats["resilience"]["checkpoints"] == full.iterations,
                  f"resilience bfs {where}: checkpoints != levels")
            res = plan.resume(step=RESUME_STEP)
            size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            for k in ("parent", "dist"):
                check(np.array_equal(res.result[k], full.result[k])
                      and np.array_equal(res.result[k], bfs.result[k]),
                      f"resilience bfs {where}: resumed {k} != uninterrupted")
            got = res.schedule_stats["direction"]["decisions"]
            check(got == want and res.iterations == full.iterations,
                  f"resilience bfs {where}: resumed decisions {got} != {want}")
            say(f"phase resilience bfs {where}: {full.iterations} levels checkpointed "
                f"({size / 1e6:.1f} MB on disk), resumed from level {RESUME_STEP}: parent, "
                f"dist and decisions equal ({time.perf_counter() - t0:.1f} s with planning)")
            del plan
        torch.cuda.empty_cache()
    store._device_cache.clear()
    torch.cuda.empty_cache()

    total = torch.cuda.get_device_properties(dev).total_memory
    try:
        torch.empty(2 * total, dtype=torch.uint8, device=dev)
        check(False, "allocating twice the card's memory succeeded")
    except torch.cuda.OutOfMemoryError as e:
        kind = classify(e)
    check(kind == "oom", f"a real OutOfMemoryError classified as {kind!r}")
    x = torch.ones(1 << 24, device=dev)
    check(float(x.sum()) == float(1 << 24), "an allocation after the OOM failed")
    say(f"phase resilience oom: allocating {2 * total / 1e9:.0f} GB raised OutOfMemoryError, "
        f"classified {kind!r}; a 64 MiB allocation after it works")


def personalized64(g, seed_sets, iterations):
    """Personalized PageRank's formula in float64 (teleport and dangling
    mass to each query's restart vector), column q taken after
    ``iterations[q]`` iterations."""
    at = csr_matrix(g).T.tocsr()
    deg = g.degrees
    inv = 1.0 / np.maximum(deg, 1)
    dangling = deg == 0
    r = np.zeros((g.n, len(seed_sets)))
    for q, seeds in enumerate(seed_sets):
        np.add.at(r[:, q], seeds, 1.0 / len(seeds))
    x = r.copy()
    out = [None] * len(seed_sets)
    for it in range(1, max(iterations) + 1):
        x = 0.15 * r + 0.85 * (at @ (x * inv[:, None]) + x[dangling].sum(0)[None, :] * r)
        for q in np.flatnonzero(np.asarray(iterations) == it):
            out[q] = x[:, q].copy()
    return out


def serve_batches(srv, uids) -> list[dict]:
    """Step ``srv`` until every query of ``uids`` is done, one batch a
    step: per batch its real and bucket rows, steps (iterations × waves),
    host ms (the step ends in a synchronise) and kernel launches."""
    import torch
    from repro_torch.kernels import registry

    out = []
    for _ in range(2 * len(uids)):
        if all(srv.result(u) is not None for u in uids):
            break
        before = srv.stats()["steps_executed"]
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        done = srv.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = srv.stats()
        check(done > 0, f"serve: a step completed no query ({st})")
        out.append(dict(real=st["batch_sizes"][-1], bucket=st["bucket_sizes"][-1],
                        steps=st["steps_executed"] - before, ms=ms,
                        launches=registry.launch_counts()))
    check(all(srv.result(u) is not None and srv.result(u).status == "done" for u in uids),
          "serve: a query did not complete")
    return out


def serve_rows_match(got, want, what) -> tuple[float, float, float]:
    """A batched PageRank row against its solo run: (max |diff|, max
    relative diff where the solo rank is above SERVE_PR_ATOL, L1)."""
    diff = np.abs(got.astype(np.float64) - want)
    big = np.abs(want) > SERVE_PR_ATOL
    rel = float((diff[big] / np.abs(want[big])).max()) if big.any() else 0.0
    l1 = float(diff.sum())
    check(np.allclose(got, want, rtol=SERVE_PR_RTOL, atol=SERVE_PR_ATOL) and l1 <= SERVE_PR_L1,
          f"serve {what}: max diff {diff.max()}, max relative {rel}, L1 {l1} to the solo run")
    return float(diff.max()), rel, l1


def serve_footprint(srv, base, dev, what, card) -> None:
    """The priced high water beside the allocator's growth over the phase."""
    import torch

    st = srv.stats()
    peak = torch.cuda.max_memory_allocated(dev) - base
    say(f"phase serve {what}: priced high water {st['footprint_high_water_bytes'] / 1e9:.3f} GB"
        f" (budget {'none' if st['budget_bytes'] is None else f'{st["budget_bytes"] / 1e9:.3f} GB'}), "
        f"max_memory_allocated growth over the phase {peak / 1e9:.3f} GB; latency p50 "
        f"{st['latency_s']['p50']:.3f} s, p95 {st['latency_s']['p95']:.3f} s [{card}]")


def phase_serve(dev, store, schedule, gen, card):
    """GraphServer over the PageRank store: in-core, 8 personalized
    PageRank queries, 8 BFS (auto) queries, one k-core and one CC, each
    held against its solo run (PageRank also against float64); then the
    same store streamed under a quarter of its footprint with a serving
    budget of resident + 3 queries, 8 PageRank queries cut to
    SERVE_STREAM_ITERS iterations.  Times the batched kernels at Q=8 on
    the inputs the path gave them; ``card`` (nvidia-smi's name and power
    limit) is printed beside every number.  Returns the two records."""
    import torch
    from repro_torch.algorithms import bfs_algorithm, pagerank_algorithm
    from repro_torch.core import batch_state_bytes, batch_states, compile_plan, tree_array_bytes
    from repro_torch.kernels import ref, registry
    from repro_torch.kernels.frontier_tiles import frontier_tiles_cuda
    from repro_torch.kernels.spmv_tiles import spmv_tiles_cuda
    from repro_torch.serve import GraphServer, Query

    cfg = PAGERANK
    kw = dict(tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    g = store.graph

    def draw(k, hi):
        return torch.randint(0, hi, (k,), generator=gen, device=dev).cpu().numpy()

    seed_sets = [sorted(set(draw(int(draw(1, SERVE_SEEDS[1])[0]) + SERVE_SEEDS[0], g.n)
                            .tolist())) for _ in range(SERVE_MAX_BATCH)]
    sources = [int(np.argmax(store.degrees))] + draw(SERVE_MAX_BATCH - 1, g.n).tolist()
    pr = dict(tol=SERVE_TOL, max_iters=SERVE_PR_ITERS)

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = GraphServer(max_batch=SERVE_MAX_BATCH, device=dev)
    srv.register_graph("web", store, **kw)
    srv.register_graph("web-bfs", store, direction="auto", **kw)
    up = [srv.submit(Query("web", "pagerank", dict(pr, seeds=s))) for s in seed_sets]
    ub = [srv.submit(Query("web-bfs", "bfs", dict(source=s))) for s in sources]
    uk = srv.submit(Query("web", "kcore", dict(k=KCORE_K)))
    uc = srv.submit(Query("web", "cc"))
    say(f"phase serve in-core: 4 resident plans and {len(up) + len(ub) + 2} queries submitted "
        f"in {time.perf_counter() - t0:.1f} s, resident {srv.admission.resident_bytes / 1e9:.3f}"
        f" GB priced")
    batches = serve_batches(srv, up + ub + [uk, uc])
    check([b["real"] for b in batches] == [8, 8, 1, 1] and batches[0]["bucket"] == 8,
          f"serve in-core batches {[(b['real'], b['bucket']) for b in batches]}")
    prb, bfsb = batches[0], batches[1]
    pulls = srv.result(ub[0]).schedule_stats["direction"]["decisions"].count("pull")
    check(prb["launches"]["spmv_tiles"] == prb["steps"],
          f"serve pagerank batch: spmv_tiles launches {prb['launches']['spmv_tiles']} != "
          f"iterations {prb['steps']}")
    check(pulls > 0 and bfsb["launches"]["frontier_tiles"] == pulls,
          f"serve bfs batch: frontier_tiles launches {bfsb['launches']['frontier_tiles']} != "
          f"pull levels {pulls}")
    launches = {k: sum(b["launches"][k] for b in batches) for k in prb["launches"]}
    for b, what in zip(batches, ("pagerank", "bfs", "kcore", "cc")):
        say(f"phase serve in-core {what} batch: {b['real']}/{b['bucket']} rows, {b['steps']} "
            f"iterations, {b['ms']:.1f} ms ({b['ms'] / b['real']:.1f} ms a query), launches "
            f"spmv_tiles {b['launches']['spmv_tiles']}, frontier_tiles "
            f"{b['launches']['frontier_tiles']} [{card}]")
    serve_footprint(srv, base, dev, "in-core", card)

    # solo runs through the same resident plans
    plan = srv.plan_for("web", "pagerank", dict(pr, seeds=seed_sets[0]))
    solo_ms, iters, diffs = [], [], []
    for s, u in zip(seed_sets, up):
        t1 = time.perf_counter()
        res = plan.run(state=pagerank_algorithm(seeds=s, **pr).init_state(store))
        solo_ms.append((time.perf_counter() - t1) * 1e3)
        iters.append(res.iterations)
        got = srv.result(u).result
        check(got.shape == (g.n,) and bool(np.isfinite(got).all()), "serve pagerank finite")
        diffs.append(serve_rows_match(got, res.result, f"pagerank seeds {s}"))
    want = personalized64(g, seed_sets, iters)
    l1 = max(float(np.abs(srv.result(u).result.astype(np.float64) - w).sum())
             for u, w in zip(up, want))
    check(l1 <= PAGERANK_L1_TOL, f"serve pagerank L1 to float64 {l1} > {PAGERANK_L1_TOL}")
    say(f"phase serve in-core pagerank: rows within rtol {SERVE_PR_RTOL}, atol {SERVE_PR_ATOL} "
        f"of their solo runs (largest max |diff|, relative, L1: "
        f"{[f'{max(d[i] for d in diffs):.2e}' for i in range(3)]}; iterations {iters}), L1 to "
        f"float64 scipy at most {l1:.3e}; batch "
        f"{prb['ms'] / prb['real']:.1f} ms a query amortized vs solo {np.mean(solo_ms):.1f} ms "
        f"[{card}]")
    bplan = srv.plan_for("web-bfs", "bfs", dict(source=sources[0]))
    solo_ms = []
    for s, u in zip(sources, ub):
        t1 = time.perf_counter()
        res = bplan.run(state=bfs_algorithm(s).init_state(store))
        solo_ms.append((time.perf_counter() - t1) * 1e3)
        for k in ("parent", "dist"):
            check(np.array_equal(srv.result(u).result[k], res.result[k]),
                  f"serve bfs source {s}: {k} != solo")
    say(f"phase serve in-core bfs: parent and dist equal the solo runs; batch "
        f"{bfsb['ms'] / bfsb['real']:.1f} ms a query amortized vs solo {np.mean(solo_ms):.1f} ms "
        f"[{card}]")
    # each batch again, warm (its plan, allocator and kernels already used),
    # with the device's busy time
    for what, p, states in (
            ("pagerank", plan, [pagerank_algorithm(seeds=s, **pr).init_state(store)
                                for s in seed_sets]),
            ("bfs", bplan, [bfs_algorithm(s).init_state(store) for s in sources])):
        batched = batch_states(states)
        res, wall, busy, top = device_profile(lambda: p.run(state=batched))
        say(f"phase serve in-core {what}: warm batch of {len(states)} {wall:.1f} ms wall "
            f"({wall / len(states):.1f} ms a query), {res.iterations} iterations, device busy "
            + (f"not measured ({top})" if busy is None else
               f"{busy:.1f} ms (idle share {1 - busy / wall:.3f}); busiest kernels {top}")
            + f" [{card}]")
    check(np.array_equal(srv.result(uk).result, srv.plan_for(
        "web", "kcore", dict(k=KCORE_K)).run().result), "serve kcore != solo")
    check(np.array_equal(srv.result(uc).result, srv.plan_for("web", "cc").run().result),
          "serve cc != solo")
    say("phase serve in-core: k-core and CC equal their solo runs")

    # the batched kernels at Q=8 on the inputs the path gave them
    ctx = plan.context
    t = ctx.tile_dim
    nd = ctx.tiles.shape[0]
    cols = torch.arange(t, device=dev)
    extents = (ctx.tile_rows, ctx.tile_cols)
    ranks = torch.from_numpy(np.stack([srv.result(u).result for u in up])).to(dev)
    contrib = ranks * ctx.extras["inv_deg"]
    xs = torch.cat([contrib, contrib.new_zeros(len(up), t)], 1)[
        :, ctx.tile_row_start[:, None] + cols]
    want_ys = ref.spmv_tiles_ref(ctx.tiles, xs)
    got = spmv_tiles_cuda(ctx.tiles, xs, extents)
    err = float((got - want_ys).abs().max())
    atol = SPMV_ATOL * min(1.0, float(want_ys.abs().max()))
    check(torch.allclose(got, want_ys, rtol=SPMV_RTOL, atol=atol),
          f"spmv_tiles Q={len(up)} serve inputs vs plain: max err {err}")
    check(all(torch.equal(got[i], spmv_tiles_cuda(ctx.tiles, xs[i], extents))
              for i in range(len(up))), "spmv_tiles serve inputs: a row != its Q=1 launch")
    area = float((ctx.tile_rows.double() * ctx.tile_cols.double()).sum())
    x_read = float(ctx.tile_rows.double().sum()) * xs.element_size()
    q = len(up)
    spmv = record(
        f"spmv_tiles[Q={q}]", launches["spmv_tiles"], err,
        cuda_ms(lambda: spmv_tiles_cuda(ctx.tiles, xs, extents), 20),
        cuda_ms(lambda: ref.spmv_tiles_ref(ctx.tiles, xs), 2),
        area * ctx.tiles.element_size() + q * (x_read + nd * t * 4) + 2 * nd * 4,
        2.0 * area * q, cuda_ms(lambda: torch.einsum("brc,qbr->qbc", ctx.tiles, xs), 3),
        kernel="spmv_tiles")
    solo8 = cuda_ms(lambda: [spmv_tiles_cuda(ctx.tiles, xs[i], extents) for i in range(q)], 10)
    say(f"  spmv_tiles[Q={q}]: {q} Q=1 launches {solo8:.4f} ms [{card}]")

    bctx = bplan.context
    dists = np.stack([srv.result(u).result["dist"] for u in ub])
    decisions = srv.result(ub[0]).schedule_stats["direction"]["decisions"]
    level = max((it for it, d in enumerate(decisions) if d == "pull"),
                key=lambda it: int((dists == it).sum()))
    frontier = torch.from_numpy(dists == level).to(dev)
    fcols = torch.cat([frontier, frontier.new_zeros(len(ub), t)], 1)[
        :, bctx.tile_col_start[:, None] + cols]
    bext = (bctx.tile_rows, bctx.tile_cols)
    want_f = ref.frontier_tiles_ref(bctx.tiles, fcols)
    got = frontier_tiles_cuda(bctx.tiles, fcols, bext)
    check(torch.equal(got, want_f), "frontier_tiles serve inputs vs plain")
    check(all(torch.equal(got[i], frontier_tiles_cuda(bctx.tiles, fcols[i], bext))
              for i in range(len(ub))), "frontier_tiles serve inputs: a row != its Q=1 launch")
    inside = fcols & (cols[None, None, :] < bctx.tile_cols[None, :, None])
    needed = frontier_needed(inside, want_f, bctx.tile_rows)
    apart = sum(frontier_needed(inside[i], want_f[i], bctx.tile_rows) for i in range(len(ub)))
    frontier = record(
        f"frontier_tiles[Q={len(ub)}]", launches["frontier_tiles"],
        float((got.long() - want_f.long()).abs().max()),
        cuda_ms(lambda: frontier_tiles_cuda(bctx.tiles, fcols, bext), 20),
        cuda_ms(lambda: ref.frontier_tiles_ref(bctx.tiles, fcols), 2),
        needed * 4 + len(ub) * (float(bctx.tile_cols.sum()) + nd * t * 4) + 2 * nd * 4,
        needed, None, kernel="frontier_tiles")
    solo8 = cuda_ms(lambda: [frontier_tiles_cuda(bctx.tiles, fcols[i], bext)
                             for i in range(len(ub))], 10)
    say(f"  frontier_tiles[Q={len(ub)}] timed on pull level {level} ({int(inside.sum())} "
        f"frontier columns; {needed:.0f} tile elements needed by the batch, {apart:.0f} by its "
        f"queries apart): {len(ub)} Q=1 launches {solo8:.4f} ms [{card}]")
    del srv, plan, bplan, ctx, bctx, xs, fcols, got, want_ys, want_f
    store._device_cache.clear()
    torch.cuda.empty_cache()

    # streamed: the serving budget admits three queries beside the plan
    wave_budget = quarter_budget(pagerank_algorithm(), store, schedule, STREAM_SPLIT)
    spr = dict(tol=SERVE_TOL, max_iters=SERVE_STREAM_ITERS)
    t0 = time.perf_counter()
    # both plans keep their waves and stay on the device (no rebalance or
    # host peel from measured wave times), so that a batch and a solo run
    # launch and fold alike
    skw = dict(kw, memory_budget=wave_budget, rebalance_threshold=None, host_fraction=None)
    probe = compile_plan(pagerank_algorithm(**spr), store, device=dev, **skw)
    per_q = batch_state_bytes(tree_array_bytes(
        pagerank_algorithm(seeds=[0]).init_state(store)), 1)
    budget = probe.resident_device_bytes + 3 * per_q
    check(probe.num_waves >= 4, f"serve streamed: {probe.num_waves} waves < 4")
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    srv = GraphServer(memory_budget=budget, max_batch=SERVE_MAX_BATCH, device=dev)
    srv.register_graph("web", store, **skw)
    stream_seeds = seed_sets[:SERVE_STREAM_QUERIES]
    uids = [srv.submit(Query("web", "pagerank", dict(spr, seeds=s))) for s in stream_seeds]
    depth = srv.stats()["queue_depth"]
    check(depth > 0, "serve streamed: the budget queued nothing")
    say(f"phase serve streamed: wave budget {wave_budget / 1e9:.3f} GB, {probe.num_waves} "
        f"waves, serving budget {budget / 1e9:.3f} GB (resident + 3 x {per_q / 1e6:.1f} MB), "
        f"{depth} of {len(uids)} queued at submission; planning {time.perf_counter() - t0:.1f} "
        f"s")
    batches = serve_batches(srv, uids)
    st = srv.stats()
    check(st["footprint_high_water_bytes"] <= budget and st["rejected"] == 0
          and st["completed"] == len(uids) and st["queued"] > 0,
          f"serve streamed stats: {st}")
    for b in batches:
        say(f"phase serve streamed pagerank batch: {b['real']}/{b['bucket']} rows, "
            f"{b['steps']} steps (iterations x {probe.num_waves} waves), {b['ms']:.0f} ms "
            f"({b['ms'] / b['real']:.0f} ms a query), launches spmv_tiles "
            f"{b['launches']['spmv_tiles']} [{card}]")
    serve_footprint(srv, base, dev, "streamed", card)
    solo_ms, solo_launches, diffs = [], [], []
    for s, u in zip(stream_seeds, uids):
        registry.reset_launch_counts()
        t1 = time.perf_counter()
        res = probe.run(state=pagerank_algorithm(seeds=s, **spr).init_state(store))
        solo_ms.append((time.perf_counter() - t1) * 1e3)
        solo_launches.append(registry.launch_counts()["spmv_tiles"])
        diffs.append(serve_rows_match(srv.result(u).result, res.result,
                                      f"streamed pagerank seeds {s}"))
    # a plan's first run adds the calibration's warm-up pass over every wave
    batch_launches = [b["launches"]["spmv_tiles"] for b in batches]
    check(batch_launches == solo_launches[:len(batches)],
          f"serve streamed: batches launched spmv_tiles {batch_launches} times, solo runs "
          f"{solo_launches}")
    say(f"phase serve streamed: {st['completed']} done, {st['queued']} queued, 0 rejected, high "
        f"water {st['footprint_high_water_bytes']} <= budget {budget}; rows within rtol "
        f"{SERVE_PR_RTOL}, atol {SERVE_PR_ATOL} of solo streamed runs (largest max |diff|, "
        f"relative, L1: {[f'{max(d[i] for d in diffs):.2e}' for i in range(3)]}; "
        f"{np.mean(solo_ms):.0f} ms each); batches "
        f"launched spmv_tiles {batch_launches} times, as many as solo runs {solo_launches} "
        f"[{card}]")
    probe.close()
    del srv, probe
    store._device_cache.clear()
    torch.cuda.empty_cache()
    return [spmv, frontier]


def phase_stream_tc(dev, store, schedule, incore, rate):
    """TC streamed on the TC dag under a third of its total footprint."""
    import torch
    from repro_torch.algorithms import tc_algorithm
    from repro_torch.kernels.tc_tiles import tc_tiles_cuda

    cfg = TC
    alg = tc_algorithm()
    budget = quarter_budget(alg, store, schedule, TC_STREAM_SPLIT)
    plan, res, launches, summary = stream_run(
        dev, "tc", alg, store, budget, rate, incore.seconds * 1e3,
        tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    check(plan.num_waves >= 2, f"stream tc: {plan.num_waves} waves < 2")
    check(res.result == incore.result, f"stream tc count {res.result} != in-core {incore.result}")
    check(launches["tc_tiles"] > 0, "stream tc: tc_tiles never launched")
    say(f"phase stream tc: {res.result} triangles, equal to in-core")
    w = max(range(plan.num_waves), key=lambda i: plan._slabs[i].nd)
    ctx = wave_context(plan, w)
    idx = ctx.extras["tc_tiles_idx"]
    ms = cuda_ms(lambda: tc_tiles_cuda(ctx.tiles, idx, (ctx.tile_rows, ctx.tile_cols)), 5)
    return (launches["tc_tiles"], ms, ctx.tiles.shape[0], plan._slabs[w].nd), summary


def stream_kernel_report(per_kernel) -> None:
    """Streamed launches per run and time per launch on the largest
    wave slab, per tile kernel."""
    for name, (launches, ms, tb, nd) in per_kernel.items():
        say(f"phase stream kernels: {name} {launches} launches per streamed run, "
            f"{ms:.4f} ms per launch on a wave slab of {nd} tiles (bucket {tb})")


def card_mesh(card: str):
    """Every card as one shard when there are two or more, else
    MESH_SHARDS shards on cuda:0; prints which."""
    import torch
    from repro_torch.core import DeviceMesh

    n = torch.cuda.device_count()
    mesh = DeviceMesh.cuda(n) if n >= 2 else DeviceMesh(["cuda:0"] * MESH_SHARDS)
    say(f"phase mesh: {mesh!r}, {mesh.size} shards on {len(mesh.distinct)} card(s) [{card}]")
    return mesh


def mesh_run(name, alg, store, budget, mesh, single, kernel, card, **kw):
    """One streamed plan under ``mesh`` at ``budget`` per shard: checks the
    shard count, every shard's staged bytes + workspace within the budget,
    bytes across the combine, each card's peak memory within its resident
    bytes + (depth + 1) × its shards' largest planned load, and ``kernel``
    launched on every shard that held tiles; prints the numbers beside
    ``single``'s (the single-device streamed run's summary).

    The planned load (a shard's staged bytes + workspace in its largest
    wave) is what the budget bounds, so this limit is the budget's own
    and tighter where the waves fill less than the budget (TC: a third
    of the footprint per shard, whose budget limit would exceed the
    card).  Each limit is also capped at the card's memory.  Returns
    (plan, result, launches per shard, shards holding tiles)."""
    import torch
    from repro_torch.core import compile_plan
    from repro_torch.kernels import registry

    cards = mesh.distinct
    for c in cards:
        torch.cuda.synchronize(c)
    torch.cuda.empty_cache()
    base = {c: torch.cuda.memory_allocated(c) for c in cards}
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    plan = compile_plan(alg, store, memory_budget=budget, mesh=mesh, **kw)
    build_s = time.perf_counter() - t0
    registry.reset_launch_counts()
    res = plan.run()
    launches = registry.launch_counts()
    st = res.schedule_stats["streaming"]
    check(st["mesh_devices"] == mesh.size, f"mesh {name}: mesh_devices {st['mesh_devices']}")
    check(all(b + w <= budget for b, w in zip(st["per_device_bytes"], st["workspace_per_wave"])),
          f"mesh {name}: a shard's staged bytes + workspace exceed the budget {budget}")
    check(st["collective_bytes"] > 0, f"mesh {name}: nothing crossed the combine")
    no_recovery(plan, f"mesh {name}")
    load = max(b + w for b, w in zip(st["per_device_bytes"], st["workspace_per_wave"]))
    peaks, limits = [], []
    for c in cards:
        shards = sum(d == c for d in mesh.devices)
        peaks.append(torch.cuda.max_memory_allocated(c) - base[c])
        limits.append(min(plan.resident_device_bytes + (plan.pipeline_depth + 1) * shards * load,
                          torch.cuda.get_device_properties(c).total_memory))
        check(peaks[-1] <= limits[-1], f"mesh {name}: {c} max_memory_allocated {peaks[-1]} > "
              f"{limits[-1]}")
    held = [any(r.run_dense and r.nds[i] > 0 for r in plan._slabs) for i in range(mesh.size)]
    per_shard = [x.get(kernel, 0) for x in st["shard_launches"]]
    check(sum(per_shard) == launches[kernel],
          f"mesh {name}: per-shard {kernel} launches {per_shard} != {launches[kernel]}")
    per_dev = sum(st["per_device_bytes"])
    steady = (st["overlapped_wall_seconds"] / st["overlapped_iterations"] * 1e3
              if st["overlapped_iterations"] else float("nan"))
    folds = st["collective_folds"]
    coll = st["phase_seconds"]["collective"] / folds * 1e3 if folds else float("nan")
    say(f"phase mesh {name}: {mesh.size} shards, budget {budget / 1e9:.3f} GB per shard, "
        f"{st['num_waves']} waves (planning {build_s:.1f} s), {per_dev / 1e9:.3f} GB staged per "
        f"device per iteration ({sum(st['bytes_per_wave']) / 1e9:.3f} GB in all), "
        f"{res.iterations} iterations in {res.seconds:.2f} s: "
        f"{res.seconds * 1e3 / res.iterations:.1f} ms per iteration (host clock; steady "
        f"overlapped {steady:.1f} ms) vs single-device streamed {single['ms']:.1f} ms (steady "
        f"{single['steady']:.1f} ms); collective {coll:.3f} ms per wave over {folds} folds "
        f"(CUDA events), {st['collective_bytes'] / 1e6:.2f} MB per shard across them; "
        f"{kernel} launches per shard {per_shard} (shards holding tiles {held}); "
        f"max_memory_allocated {[f'{x / 1e9:.2f}' for x in peaks]} GB (limits "
        f"{[f'{x / 1e9:.2f}' for x in limits]}, planned load {load / 1e9:.3f} GB a shard) "
        f"[{card}]")
    return plan, res, per_shard, held


def phase_mesh(dev, store, schedule, runs, bfs, pagerank, pr_three, card):
    """The device mesh on the PageRank store, one controller over
    card_mesh()'s shards, each under phase stream's budget per shard:
    PageRank hybrid (MESH_PR_ITERS iterations) against in-core, BFS auto
    bit for bit (parents, distances, decisions) against in-core, and the
    DistributedEngine's PageRank (the reference test's edge update) over
    MESH_DIST_ITERS steps against in-core and float64.  Returns the mesh."""
    import torch
    from repro_torch.algorithms import bfs_algorithm, pagerank_algorithm
    from repro_torch.core import DistributedEngine, build_schedule

    cfg = PAGERANK
    kw = dict(tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    mesh = card_mesh(card)

    plan, res, per, held = mesh_run(
        "pagerank", pagerank_algorithm(max_iters=MESH_PR_ITERS), store,
        runs["pagerank"]["budget"], mesh, runs["pagerank"], "spmv_tiles", card, **kw)
    check(res.iterations == MESH_PR_ITERS, f"mesh pagerank: {res.iterations} iterations")
    check(any(held) and all(p > 0 for p, h in zip(per, held) if h),
          f"mesh pagerank: spmv_tiles launches per shard {per}, tiles held {held}")
    n = store.n
    err = np.abs(res.result.astype(np.float64) - pr_three)
    rel = float((err / np.maximum(np.abs(pr_three), 1e-30)).max())
    l1 = float(err.sum())
    check(bool(np.allclose(res.result, pr_three, rtol=MESH_PR_RTOL, atol=MESH_PR_ATOL)),
          f"mesh pagerank vs in-core ({MESH_PR_ITERS} iterations): largest relative "
          f"difference {rel}")
    check(l1 <= MESH_PR_L1, f"mesh pagerank L1 to in-core {l1} > {MESH_PR_L1}")
    say(f"phase mesh pagerank: {MESH_PR_ITERS} iterations within rtol {MESH_PR_RTOL}, atol "
        f"{MESH_PR_ATOL} of in-core: largest relative difference {rel:.2e}, L1 "
        f"{l1:.3e} (limit {MESH_PR_L1})")
    del plan

    src = int(np.argmax(store.degrees))
    plan, res, per, held = mesh_run(
        "bfs", bfs_algorithm(src), store, runs["bfs"]["budget"], mesh, runs["bfs"],
        "frontier_tiles", card, direction="auto", **kw)
    for k in ("parent", "dist"):
        check(np.array_equal(res.result[k], bfs.result[k]), f"mesh bfs {k} != in-core")
    decisions = res.schedule_stats["direction"]["decisions"]
    check(decisions == bfs.schedule_stats["direction"]["decisions"],
          f"mesh bfs decisions {decisions} != in-core")
    check("pull" in decisions and any(held) and all(p > 0 for p, h in zip(per, held) if h),
          f"mesh bfs: frontier_tiles launches per shard {per}, tiles held {held}")
    say(f"phase mesh bfs: parent, dist and decisions equal in-core ({decisions})")
    del plan

    # the reference test's DistributedEngine PageRank (tests/test_distributed.py)
    t0 = time.perf_counter()
    sched = build_schedule(pagerank_algorithm(), store, num_devices=mesh.size,
                           mode="sparse_only")
    inv = 1.0 / np.maximum(np.diff(store.indptr), 1)
    inv_deg = {c: torch.from_numpy(inv).float().to(c) for c in mesh.distinct}

    def edge_update(src_, dst_, valid, state):
        contrib = state["rank"] * inv_deg[src_.device]
        vals = torch.where(valid, contrib[src_], 0.0)
        acc = torch.zeros(n, dtype=torch.float32, device=src_.device)
        return dict(rank=state["rank"], acc=acc.index_add_(0, dst_, vals))

    eng = DistributedEngine(store, sched, edge_update, combine=dict(rank="max", acc="add"),
                            mesh=mesh)
    build_s = time.perf_counter() - t0
    state = dict(rank=torch.full((n,), 1.0 / n, device=dev), acc=torch.zeros(n, device=dev))
    dangling = torch.from_numpy(np.diff(store.indptr) == 0).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_DIST_ITERS):
        state = eng.step(state)
        dm = torch.where(dangling, state["rank"], 0.0).sum()
        state = dict(rank=0.15 / n + 0.85 * (state["acc"] + dm / n),
                     acc=torch.zeros(n, device=dev))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MESH_DIST_ITERS
    got = state["rank"].cpu().numpy()
    check(bool(np.isfinite(got).all()) and got.shape == (n,), "distributed pagerank shape")
    diff = float(np.abs(got - pagerank.result).max())
    check(diff < MESH_DIST_TOL, f"distributed pagerank vs in-core: max |diff| {diff}")
    l1 = float(np.abs(got.astype(np.float64) - pagerank64(store.graph, MESH_DIST_ITERS)).sum())
    check(l1 <= PAGERANK_L1_TOL, f"distributed pagerank L1 to float64 {l1} > {PAGERANK_L1_TOL}")
    say(f"phase mesh distributed: DistributedEngine PageRank over {mesh.size} shards, "
        f"{MESH_DIST_ITERS} steps in {step_ms:.2f} ms each (host clock; build {build_s:.1f} s); "
        f"max |diff| to in-core ({pagerank.iterations} iterations) {diff:.2e} (limit "
        f"{MESH_DIST_TOL}), L1 to float64 scipy {l1:.3e} [{card}]")
    del eng, state
    torch.cuda.empty_cache()
    return mesh


def phase_mesh_tc(store, schedule, incore, single, mesh, card):
    """TC hybrid streamed under ``mesh`` on the TC dag at phase stream's
    third of its footprint per shard, exactly the in-core count."""
    from repro_torch.algorithms import tc_algorithm

    cfg = TC
    alg = tc_algorithm()
    budget = quarter_budget(alg, store, schedule, TC_STREAM_SPLIT)
    plan, res, per, held = mesh_run("tc", alg, store, budget, mesh, single, "tc_tiles", card,
                                    tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    check(res.result == incore.result, f"mesh tc count {res.result} != in-core {incore.result}")
    check(any(held) and all(p > 0 for p, h in zip(per, held) if h),
          f"mesh tc: tc_tiles launches per shard {per}, tiles held {held}")
    say(f"phase mesh tc: {res.result} triangles, equal to in-core")


def synced_run(plan):
    """``plan.run()`` on the host clock between two synchronizations:
    (result, ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan.run()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def suite_oracles(g, dag) -> dict:
    """scipy's answers on ``g``: components, BFS distances from vertex 0,
    and the exact triangle count of its DAG ``dag``."""
    import scipy.sparse.csgraph as csgraph

    return dict(comp=csgraph.connected_components(csr_matrix(g), directed=False)[1],
                dist=bfs64(g, 0), triangles=tc64(dag))


def suite_check(name, algo, g, res, want) -> None:
    """One table-1 result against float64 scipy (PageRank at the run's
    iteration count) or scipy's exact answer."""
    if algo == "pr":
        check(bool(np.isfinite(res.result).all()) and res.result.shape == (g.n,),
              f"suite {name} pr: result shape/finite")
        l1 = float(np.abs(res.result.astype(np.float64) - pagerank64(g, res.iterations)).sum())
        check(l1 <= PAGERANK_L1_TOL, f"suite {name} pr: L1 to float64 {l1} > {PAGERANK_L1_TOL}")
    elif algo in ("sv", "cc"):
        check(same_partition(res.result, want["comp"]), f"suite {name} {algo}: components")
    elif algo == "bfs":
        check(np.array_equal(res.result["dist"].astype(np.int64), want["dist"]),
              f"suite {name} bfs: dist != scipy distances")
    else:
        check(res.result == want["triangles"],
              f"suite {name} tc: {res.result} triangles != scipy {want['triangles']}")


def phase_suite(dev, card: str) -> None:
    """``benchmark_suite("bench")`` at table 1's plan settings (35 runs, each
    against scipy), the skewed classes at the chip layout (against their
    table-1 runs through the permutation; the three tile kernels must
    launch), and one traced streamed PageRank exported as a Chrome trace;
    prints the phase's numbers as one run report."""
    import tempfile

    from repro_torch import obs
    from repro_torch.algorithms import (
        afforest_algorithm, bfs_algorithm, pagerank_algorithm, sv_algorithm, tc_algorithm,
    )
    from repro_torch.algorithms.tc import orient_dag
    from repro_torch.core import build_block_store, compile_plan, degree_order
    from repro_torch.data import benchmark_suite
    from repro_torch.kernels import registry

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    graphs = benchmark_suite("bench")
    gen_s = time.perf_counter() - t0
    say(f"phase suite: benchmark_suite('bench') built {len(graphs)} graphs in {gen_s:.2f} s "
        f"(host)")
    report = dict(card=card, generate_s=gen_s, graphs={}, table1=[], chip=[])

    # table 1: p=4, hybrid, density 0.001, tile_dim 512 (benchmarks/table1_graphs.py)
    t1 = SUITE_TABLE1
    algos = dict(pr=pagerank_algorithm, sv=sv_algorithm, cc=afforest_algorithm,
                 bfs=lambda: bfs_algorithm(0), tc=tc_algorithm)
    table1 = {}
    for name, g in graphs.items():
        t0 = time.perf_counter()
        dag = orient_dag(g)
        stores = dict(graph=build_block_store(g, t1["p"]), dag=build_block_store(dag, t1["p"]))
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = suite_oracles(g, dag)
        oracle_s = time.perf_counter() - t0
        report["graphs"][name] = dict(n=g.n, arcs=g.m, dag_arcs=dag.m, stores_s=build_s)
        cells = []
        for algo, make in algos.items():
            plan = compile_plan(make(), stores["dag" if algo == "tc" else "graph"], device=dev,
                                mode=t1["mode"], dense_density=t1["dense_density"],
                                tile_dim=t1["tile_dim"])
            plan.run()                      # warm: the timed run is the second
            res, ms = synced_run(plan)
            no_recovery(plan, f"suite {name} {algo}")
            suite_check(name, algo, g, res, want)
            dense = int(plan.schedule.stats["dense_tasks"])
            table1[name, algo] = res
            report["table1"].append(dict(graph=name, algo=algo, ms=ms, iterations=res.iterations,
                                         dense_tasks=dense))
            cells.append(f"{algo} {ms:.1f} ms {res.iterations} it {dense} dense")
        say(f"phase suite table1 {name}: n {g.n}, arcs {g.m}, stores {build_s:.2f} s, scipy "
            f"{oracle_s:.2f} s (host); " + "; ".join(cells) + " (host clock, synchronized); "
            f"equal to scipy")
    dense_runs = sum(r["dense_tasks"] > 0 for r in report["table1"])
    say(f"phase suite table1: {len(report['table1'])} runs, {dense_runs} with a dense task")

    # the chip layout on the skewed classes: hub corners go dense
    cfg = SUITE_CHIP
    kernels = ("spmv_tiles", "frontier_tiles", "tc_tiles")
    registry.reset_launch_counts()
    chip_stores = {}
    for name in SUITE_CHIP_GRAPHS:
        t0 = time.perf_counter()
        go, perm = degree_order(graphs[name], ascending=False)
        p = -(-go.n // cfg["tile_dim"])
        store = build_block_store(go, p)
        chip_stores[name] = store
        runs = (("pr", pagerank_algorithm(), store, dict(dense_density=cfg["dense_density"])),
                ("bfs", bfs_algorithm(int(perm[0])), store,
                 dict(dense_density=cfg["dense_density"], direction="auto")),
                ("tc", tc_algorithm(), build_block_store(orient_dag(go), p),
                 dict(dense_density=cfg["tc_dense_density"])))
        build_s = time.perf_counter() - t0
        cells = []
        for algo, alg, st, kw in runs:
            plan = compile_plan(alg, st, device=dev, tile_dim=cfg["tile_dim"], **kw)
            plan.run()
            before = registry.launch_counts()
            res, ms = synced_run(plan)
            after = registry.launch_counts()
            no_recovery(plan, f"suite chip {name} {algo}")
            launched = {k: after[k] - before[k] for k in kernels if after[k] > before[k]}
            base = table1[name, algo]
            check(res.iterations == base.iterations,
                  f"suite chip {name} {algo}: {res.iterations} iterations != table 1's "
                  f"{base.iterations}")
            if algo == "pr":
                got = res.result[perm]
                worst = float(np.max(np.abs(got - base.result) / np.abs(base.result)))
                check(np.allclose(got, base.result, rtol=SUITE_PR_RTOL, atol=0.0),
                      f"suite chip {name} pr: ranks differ from table 1's by rtol {worst}")
                extra = f"rtol to table 1 {worst:.2e}"
            elif algo == "bfs":
                check(np.array_equal(res.result["dist"][perm], base.result["dist"]),
                      f"suite chip {name} bfs: dist != table 1's")
                extra = f"decisions {res.schedule_stats['direction']['decisions']}"
            else:
                check(res.result == base.result,
                      f"suite chip {name} tc: {res.result} != table 1's {base.result}")
                extra = f"{res.result} triangles"
            dense = int(plan.schedule.stats["dense_tasks"])
            report["chip"].append(dict(graph=name, algo=algo, p=p, ms=ms,
                                       iterations=res.iterations, dense_tasks=dense,
                                       launches=launched))
            cells.append(f"{algo} {ms:.1f} ms {res.iterations} it {dense} dense, launches "
                         f"{launched}, {extra}")
        say(f"phase suite chip {name}: p {p}, stores {build_s:.2f} s (host); " + "; ".join(cells))
    launches = registry.launch_counts()
    for k in kernels:
        check(launches[k] > 0, f"suite chip layout: {k} never launched")
    say(f"phase suite chip: launches {dict((k, launches[k]) for k in kernels)}; every result "
        f"equals its table-1 run through the permutation")

    # one traced streamed PageRank, exported and validated
    tr_cfg = SUITE_TRACE
    store = chip_stores[tr_cfg["graph"]]
    alg = pagerank_algorithm(max_iters=tr_cfg["iterations"], tol=0.0)
    incore = compile_plan(alg, store, device=dev, tile_dim=cfg["tile_dim"],
                          dense_density=cfg["dense_density"])
    budget = quarter_budget(alg, store, incore.schedule, STREAM_SPLIT)
    del incore
    splan = compile_plan(alg, store, device=dev, tile_dim=cfg["tile_dim"],
                         dense_density=cfg["dense_density"], memory_budget=budget,
                         pipeline_depth=tr_cfg["pipeline_depth"])
    plain = splan.run()
    with obs.tracing() as tr:
        traced, wall, busy, top = device_profile(splan.run)
        events = tr.events()
        dropped = tr.dropped
    no_recovery(splan, "suite trace")
    check(dropped == 0, f"suite trace: {dropped} spans dropped")
    waves = traced.schedule_stats["streaming"]["num_waves"]
    check(waves >= tr_cfg["min_waves"], f"suite trace: {waves} waves < {tr_cfg['min_waves']}")
    check(traced.iterations == plain.iterations == tr_cfg["iterations"],
          f"suite trace: iterations {traced.iterations}, {plain.iterations}")
    check(np.allclose(traced.result, plain.result, rtol=SUITE_PR_RTOL, atol=0.0),
          "suite trace: the traced ranks differ from the untraced run's")
    phases = ("assemble", "device_put", "compute", "iteration")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "suite.perfetto.json")
        obs.export.write_chrome_trace(path, events)
        with open(path) as f:
            info = obs.export.validate_chrome_trace(
                json.load(f), require_lanes=("main", "staging", "device/0"),
                require_phases=phases)
        trace_bytes = os.path.getsize(path)
    for ph in phases[:3]:
        seen = {e.args.get("wave") for e in events if e.name == ph}
        check(seen >= set(range(waves)), f"suite trace: {ph} misses waves "
              f"{sorted(set(range(waves)) - seen)}")
    lane_ms = {}
    for e in events:
        lane_ms[e.lane] = lane_ms.get(e.lane, 0.0) + e.dur_ns / 1e6
    device_ms = {ph: sum(e.dur_ns for e in events if e.lane == "device" and e.name == ph) / 1e6
                 for ph in ("device_put", "compute")}
    st = traced.schedule_stats["streaming"]
    report["trace"] = dict(graph=tr_cfg["graph"], budget=budget, waves=waves,
                           iterations=traced.iterations, lanes=info["lanes"],
                           span_counts=info["span_counts"], trace_bytes=trace_bytes,
                           lane_ms=lane_ms, device_lane_ms=device_ms, wall_ms=wall,
                           profiler_busy_ms=busy, h2d_bytes=st["h2d_bytes"],
                           h2d_ms=st["h2d_seconds"] * 1e3)
    busy_txt = f"{busy:.1f} ms" if busy is not None else f"not measured ({top})"
    say(f"phase suite trace: {tr_cfg['graph']} streamed PageRank, budget {budget / 1e6:.2f} MB, "
        f"{waves} waves, pipeline depth {tr_cfg['pipeline_depth']}, {traced.iterations} "
        f"iterations within rtol {SUITE_PR_RTOL} of the untraced run; trace {trace_bytes} bytes, "
        f"lanes {info['lanes']}, span counts {info['span_counts']}; every wave in each phase")
    say(f"phase suite trace: device lane spans {sum(device_ms.values()):.1f} ms (device_put "
        f"{device_ms['device_put']:.1f}, compute {device_ms['compute']:.1f}: the host's enqueue) "
        f"beside torch.profiler's device busy {busy_txt}, wall {wall:.1f} ms; lane ms "
        f"{ {k: round(v, 1) for k, v in lane_ms.items()} }; copies {st['h2d_bytes'] / 1e9:.3f} "
        f"GB in {st['h2d_seconds'] * 1e3:.1f} ms on the copy stream; busiest {top}")
    seconds = time.perf_counter() - t_phase
    report["seconds"] = seconds
    say(json.dumps(obs.export.run_report("chip_suite", report)))
    say(f"phase suite: {seconds:.1f} s (limit {SUITE_SECONDS:.0f})")
    check(seconds <= SUITE_SECONDS, f"phase suite took {seconds:.1f} s > {SUITE_SECONDS} s")


def lm_config(**changes):
    from dataclasses import replace

    from repro_torch.configs import get_config

    return replace(get_config(LM_ARCH), **changes)


def prompts(rng, n, lo, hi, vocab):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist() for _ in range(n)]


def serve(cfg, model, dev, reqs, slots, cache_len):
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(cfg, model, batch_slots=slots, cache_len=cache_len, device=dev)
    for uid, (prompt, new) in enumerate(reqs):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    return {r.uid: r for r in done}, eng.steps_executed, time.perf_counter() - t0


def phase_lm_exact(dev, cfg) -> None:
    """The kernel path against the plain path, decode against prefill, and
    batched serving against solo serving, all in float32."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm

    ex = LM_EXACT
    gen = torch.Generator(device=dev).manual_seed(1)
    model = lm.LM(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (ex["batch"], ex["seq"]), generator=gen, device=dev)
    with torch.inference_mode():
        registry.reset_launch_counts()
        got = lm.forward_logits(cfg, model, dict(tokens=tokens), use_kernel=True)
        launches = registry.launch_counts()["flash_attention"]
        check(launches == cfg.n_layers,
              f"flash_attention launches {launches} != {cfg.n_layers} layers")
        want = lm.forward_logits(cfg, model, dict(tokens=tokens), use_kernel=False)
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and torch.allclose(got, want, **LM_TOL),
              f"LM logits, kernel vs plain: max err {err}")
        state = lm.init_decode_state(cfg, ex["batch"], ex["decode"], device=dev)
        derr = 0.0
        for t in range(ex["decode"]):
            logits, state = lm.decode_step(cfg, model, state, tokens[:, t])
            derr = max(derr, float((logits - got[:, t]).abs().max()))
            check(torch.allclose(logits, got[:, t], **LM_TOL),
                  f"decode logits at position {t} vs prefill: max err {derr}")
    say(f"phase lm exact: {cfg.name} {cfg.n_layers} layers float32, logits "
        f"{tuple(got.shape)}: kernel vs plain max err {err:.2e}, decode vs prefill over "
        f"{ex['decode']} positions max err {derr:.2e} (atol {LM_TOL['atol']}, rtol "
        f"{LM_TOL['rtol']}), launches {launches}")
    del got, want, state

    rng = np.random.default_rng(1)
    reqs = [(p, ex["new_tokens"]) for p in prompts(rng, ex["requests"], 2, 8, cfg.vocab)]
    batched, _, _ = serve(cfg, model, dev, reqs, ex["requests"], 32)
    for uid, req in enumerate(reqs):
        solo, _, _ = serve(cfg, model, dev, [req], 1, 32)
        check(batched[uid].output == solo[0].output,
              f"request {uid}: batched {batched[uid].output} != solo {solo[0].output}")
    say(f"phase lm exact: ServeEngine greedy outputs of {len(reqs)} batched requests equal "
        f"their solo runs")
    del model
    torch.cuda.empty_cache()


def phase_lm_full(dev, cfg):
    """The whole model in bf16: prefill with the kernel, then serving.
    Returns flash_attention's record, timed on layer 0's q, k, v."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, registry
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import attention, lm
    from repro_torch.models.common import rms_norm
    from repro_torch.models.steps import make_prefill_step

    fu = LM_FULL
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm.LM(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"phase lm: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {n_params / 1e9:.3f} B "
        f"parameters drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"memory allocated {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    b, s = fu["batch"], fu["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1))
    step = make_prefill_step(cfg, use_kernel=True)

    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = step(model, batch)
    loss = float(metrics["loss"])
    first_s = time.perf_counter() - t0
    launches = registry.launch_counts()
    check(launches["flash_attention"] == cfg.n_layers,
          f"prefill launched flash_attention {launches['flash_attention']} times, "
          f"not once per layer ({cfg.n_layers})")
    ln_v = float(np.log(cfg.vocab))
    check(np.isfinite(loss) and abs(loss - ln_v) <= LOSS_BAND,
          f"prefill loss {loss} not within {LOSS_BAND} of ln V = {ln_v:.3f}")
    t0 = time.perf_counter()
    step(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    say(f"phase lm prefill: B={b} S={s}, loss {loss:.4f} (ln V {ln_v:.4f}), first run "
        f"{first_s:.3f} s, second {prefill_s:.3f} s ({b * s / prefill_s:.0f} tokens/s, host "
        f"clock), max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
        f"launches {launches}")
    _, wall, busy, top = device_profile(lambda: step(model, batch))
    if busy is None:
        say(f"phase lm prefill: device time not measured ({top})")
    else:
        say(f"phase lm prefill: profiled run {wall:.1f} ms wall, device busy {busy:.1f} ms "
            f"(idle share {1 - busy / wall:.3f}); busiest kernels {top}")

    with torch.inference_mode():
        state = lm.init_decode_state(cfg, fu["slots"], fu["cache_len"], device=dev)
        toks = torch.zeros(fu["slots"], dtype=torch.int32, device=dev)

        def decode():
            nonlocal state
            for _ in range(DECODE_PROFILE_STEPS):
                logits, state = lm.decode_step(cfg, model, state, toks)
            return logits

        decode()                      # warm
        _, wall, busy, top = device_profile(decode)
        n = DECODE_PROFILE_STEPS
        if busy is None:
            say(f"phase lm decode: device time not measured ({top})")
        else:
            say(f"phase lm decode: profiled {n} steps of {fu['slots']} slots, "
                f"{wall / n:.2f} ms wall per step, device busy {busy / n:.2f} ms per step "
                f"(idle share {1 - busy / wall:.3f}); busiest kernels {top}")
        del state

    rng = np.random.default_rng(0)
    lo, hi = fu["prompt"]
    reqs = [(p, fu["new_tokens"]) for p in prompts(rng, fu["requests"], lo, hi, cfg.vocab)]
    torch.cuda.reset_peak_memory_stats(dev)
    done, steps, serve_s = serve(cfg, model, dev, reqs, fu["slots"], fu["cache_len"])
    check(len(done) == len(reqs) and all(r.done and not r.truncated
                                         and len(r.output) == fu["new_tokens"]
                                         for r in done.values()),
          "ServeEngine did not finish every request")
    new_tokens = sum(len(r.output) for r in done.values())
    say(f"phase lm serve: {len(reqs)} requests (prompts {lo}-{hi} tokens, "
        f"{fu['new_tokens']} new each) through {fu['slots']} slots, cache {fu['cache_len']}: "
        f"{steps} decode steps in {serve_s:.2f} s, {serve_s * 1e3 / steps:.2f} ms per step, "
        f"{new_tokens / serve_s:.1f} generated tokens/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    # time the kernel on layer 0's q, k, v from this forward
    layer = model.layers[0]
    with torch.inference_mode():
        x = rms_norm(F.embedding(tokens, model.embed), layer.ln1)
        q, k, v = (t.transpose(1, 2).contiguous() for t in attention.project_qkv(
            layer.attn, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta))
        del x, model
        torch.cuda.empty_cache()
        err, share = attn_error(flash_attention_cuda(q, k, v), q, k, v)
        check(share <= 1.0, f"flash_attention on layer 0's inputs: max err {err}, "
              f"{share:.3f} of the tolerance {ATTN_TOL[cfg.dtype]}")
        say(f"  flash_attention on layer 0's inputs: max err {err:.2e}, {share:.3f} of the "
            f"tolerance {ATTN_TOL[cfg.dtype]}")

        # S_q = S_k, so SDPA's top-left causal mask equals the suffix-aligned one
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        # information, not a check: the library's arithmetic against the same limit
        sdpa_err, sdpa_share = attn_error(sdpa(), q, k, v)
        say(f"  SDPA on layer 0's inputs: max err {sdpa_err:.2e}, {sdpa_share:.3f} of the "
            f"same tolerance (not a check)")
        library = cuda_ms(sdpa, 5)
        pairs = b * cfg.n_heads * s * (s + 1) // 2          # visible (query, key) pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        rec = record("flash_attention", launches["flash_attention"], err,
                     cuda_ms(lambda: flash_attention_cuda(q, k, v), 5),
                     cuda_ms(lambda: ref.attention_ref(q, k, v), 2),
                     nbytes, 4.0 * cfg.d_head * pairs, library, rate=BF16_TC_FLOPS)
    say(f"  flash_attention timed on layer 0's q {tuple(q.shape)}, k, v {tuple(k.shape)} "
        f"{cfg.dtype}: {4.0 * cfg.d_head * pairs / rec['ms'] / 1e9:.1f} TFLOP/s")
    return rec


def updated_params_match(got, want, opt_want, lr) -> tuple[float, float, int]:
    """Every parameter of ``got`` within STEP_TOL of ``want``'s after one
    AdamW step, except the elements whose first moment says 0 < |g| <
    1e-6 (Adam's step there moves steeply with g), held to 2 lr.  Returns
    the largest difference outside and inside that set, and its size."""
    import torch

    worst, worst_tiny, tiny_n = 0.0, 0.0, 0
    with torch.no_grad():
        for (name, a), b in zip(got.named_parameters(), want.parameters()):
            diff = (a - b).abs()
            mu = opt_want["mu"][name].abs()              # mu = (1 - 0.9) g after one step
            tiny = (mu < 1e-7) & (mu > 0)
            limit = torch.where(tiny, 2 * lr, STEP_TOL["atol"] + STEP_TOL["rtol"] * b.abs())
            bad = int((diff > limit).sum())
            check(bad == 0, f"train exact: {name} differs beyond {STEP_TOL} at {bad} elements, "
                  f"max {float(diff.max())}")
            worst = max(worst, float(torch.where(tiny, 0.0, diff).max()))
            worst_tiny = max(worst_tiny, float(torch.where(tiny, diff, 0.0).max()))
            tiny_n += int(tiny.sum())
    return worst, worst_tiny, tiny_n


def phase_train_exact(dev, cfg) -> None:
    """One make_train_step step with the kernels against one without from
    the same weights (loss, grad_norm, every updated parameter), the same
    loss with microbatch=2, and ten steps on one repeated batch that lower
    the loss below LOSS_DROP of its first value; float32, TF32 off."""
    import copy

    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw_init

    ex = TRAIN_EXACT
    gen = torch.Generator(device=dev).manual_seed(2)
    base = lm.LM(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (ex["batch"], ex["seq"]), generator=gen, device=dev)
    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1))
    runs = {}
    for use_kernel in (True, False):
        model = copy.deepcopy(base)
        opt = adamw_init(model)
        step = make_train_step(cfg, warmup_steps=1, use_kernel=use_kernel)
        registry.reset_launch_counts()
        opt, m = step(model, opt, batch, 0)
        launches = registry.launch_counts()
        runs[use_kernel] = model, opt, {k: float(v) for k, v in m.items()}, launches
    (km, _, kmet, kl), (pm, popt, pmet, pl) = runs[True], runs[False]
    check(kl["flash_attention"] == 2 * cfg.n_layers and kl["flash_attention_bwd"] == cfg.n_layers
          and pl["flash_attention"] == pl["flash_attention_bwd"] == 0,
          f"train exact: launches with the kernels {kl}, without {pl}")
    for key in ("loss", "grad_norm"):
        check(np.isfinite(kmet[key]) and np.isclose(kmet[key], pmet[key], **LM_TOL),
              f"train exact: {key} with the kernels {kmet[key]}, without {pmet[key]}")
    worst, worst_tiny, tiny = updated_params_match(km, pm, popt, kmet["lr"])
    say(f"phase train exact: {cfg.name} {cfg.n_layers} layers float32, batch "
        f"{ex['batch']} x {ex['seq']}: loss {kmet['loss']:.6f} vs {pmet['loss']:.6f} without "
        f"the kernels, grad_norm {kmet['grad_norm']:.6f} vs {pmet['grad_norm']:.6f} "
        f"({LM_TOL}); updated parameters max |diff| {worst:.2e} ({STEP_TOL}), and "
        f"{worst_tiny:.2e} on the {tiny} elements with 0 < |g| < 1e-6 (held to 2 lr = "
        f"{2 * kmet['lr']:.1e}); launches {kl}")
    del runs, km, pm, popt, model, opt
    torch.cuda.empty_cache()

    model = copy.deepcopy(base)
    opt = adamw_init(model)
    _, m = make_train_step(cfg, warmup_steps=1, use_kernel=True, microbatch=2)(
        model, opt, batch, 0)
    check(np.isclose(float(m["loss"]), pmet["loss"], rtol=1e-4),
          f"train exact: microbatch=2 loss {float(m['loss'])} vs {pmet['loss']}")
    say(f"phase train exact: microbatch=2 loss {float(m['loss']):.6f} vs {pmet['loss']:.6f} "
        f"(rtol 1e-4)")
    del model, opt
    torch.cuda.empty_cache()

    model, opt = base, adamw_init(base)
    step = make_train_step(cfg, warmup_steps=1, use_kernel=True)
    losses = []
    for i in range(ex["steps"]):
        opt, m = step(model, opt, batch, i)
        losses.append(float(m["nll"]))
    check(all(np.isfinite(losses)) and losses[-1] < LOSS_DROP * losses[0],
          f"train exact: {ex['steps']} steps on one batch, losses {losses}")
    say(f"phase train exact: {ex['steps']} steps on one repeated batch, nll "
        f"{[round(x, 4) for x in losses]} (last below {LOSS_DROP} of the first)")
    del model, opt, base
    torch.cuda.empty_cache()


def phase_train(dev, cfg, card: str) -> int:
    """Training at full width, depth cut to TRAIN's layers, bf16, through
    make_train_step with the kernels, remat "full" and two microbatches:
    one warm-up step, timed steps, a profiled step.  Returns the backward
    kernel's launches in one step."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.roofline import HW, model_flops

    tr = TRAIN
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm.LM(cfg, generator=gen, device=dev)
    opt = adamw_init(model)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    state = n * (2 + 2 + 4 + 4)       # bf16 weights and gradients, float32 moments
    acc = n * 4                       # the float32 microbatch accumulator
    say(f"phase train: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {n / 1e9:.3f} B parameters "
        f"and moments on the card in {time.perf_counter() - t0:.1f} s, memory allocated "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    b, s = tr["batch"], tr["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1))
    step = make_train_step(cfg, use_kernel=True, microbatch=tr["microbatch"])
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    opt, m = step(model, opt, batch, 0)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    first_s = time.perf_counter() - t0
    launches = registry.launch_counts()
    mb, layers = tr["microbatch"], cfg.n_layers
    check(launches["flash_attention"] == 2 * layers * mb
          and launches["flash_attention_bwd"] == layers * mb,
          f"train: launches in one step {launches}, expected flash_attention "
          f"{2 * layers * mb} (remat: twice a layer a microbatch) and its backward {layers * mb}")
    ln_v = float(np.log(cfg.vocab))
    check(np.isfinite(loss) and abs(loss - ln_v) <= LOSS_BAND and np.isfinite(gnorm),
          f"train: step 0 loss {loss} (ln V {ln_v:.3f}, band {LOSS_BAND}), grad_norm {gnorm}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(1, tr["timed"] + 1):
        opt, m = step(model, opt, batch, i)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / tr["timed"]
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)) and np.isfinite(float(m["grad_norm"])),
          f"train: losses {losses}, grad_norm {float(m['grad_norm'])}")
    flops = model_flops(cfg, ShapeSpec("train_4k_cut", s, b, "train"))
    peak = torch.cuda.max_memory_allocated(dev)
    say(f"phase train: B={b} S={s} in {mb} microbatches, step 0 loss {loss:.4f} (ln V "
        f"{ln_v:.4f}), grad_norm {gnorm:.4f}, first step {first_s:.2f} s; "
        f"{tr['timed']} steps {step_s * 1e3:.1f} ms each ({b * s / step_s:.0f} tokens/s, host "
        f"clock), losses {[round(x, 4) for x in losses]}; model FLOPs {flops:.3e} a step, "
        f"{flops / step_s / HW().peak_flops:.3f} of 989 TFLOP/s; max_memory_allocated "
        f"{peak / 1e9:.2f} GB (state {state / 1e9:.2f} GB + float32 accumulator "
        f"{acc / 1e9:.2f} GB); launches a step {launches} [{card}]")
    _, wall, busy, kernels = device_profile(lambda: step(model, opt, batch, tr["timed"] + 1),
                                            top=None)
    if busy is None:
        say(f"phase train: device time not measured ({kernels})")
    else:
        bwd = sum(t for key, t in kernels if re.search(r"delta_kernel|dkdv_kernel|dq_kernel", key))
        say(f"phase train: profiled step {wall:.1f} ms wall, device busy {busy:.1f} ms (idle "
            f"share {1 - busy / wall:.3f}); flash_attention_bwd {bwd:.1f} ms ({bwd / busy:.3f} "
            f"of busy); busiest kernels {kernels[:5]}")
    del model, opt, batch, m
    torch.cuda.empty_cache()
    return launches["flash_attention_bwd"]


def phase_train_loop(dev) -> None:
    """``python -m repro_torch.launch.train`` on the smoke config for a few
    steps, then a TrainLoop cut after TRAIN_LOOP["cut"] steps and resumed,
    whose final parameters equal the uninterrupted run's (STEP_TOL, the
    reference's resume check)."""
    import tempfile
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.train import TrainConfig, TrainLoop

    lp = TRAIN_LOOP
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH, "--smoke",
               "--steps", "4", "--batch", str(lp["batch"]), "--seq", str(lp["seq"]),
               "--ckpt-dir", os.path.join(tmp, "launch"), "--ckpt-every", "2", "--use-kernel"]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600,
                             env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        check(out.returncode == 0 and "done:" in out.stdout,
              f"launch.train exited {out.returncode}: {out.stdout[-2000:]} {out.stderr[-2000:]}")
        say(f"phase train loop: launch.train {out.stdout.strip().splitlines()[-1]!r} in "
            f"{time.perf_counter() - t0:.1f} s, checkpoints "
            f"{sorted(os.listdir(os.path.join(tmp, 'launch')))}")
        cfg = replace(get_smoke(LM_ARCH), dtype="float32")
        tc = TrainConfig(steps=lp["steps"], batch=lp["batch"], seq=lp["seq"],
                         ckpt_dir=os.path.join(tmp, "full"), ckpt_every=2, base_lr=1e-3,
                         warmup_steps=2, log_every=1)
        full = TrainLoop(cfg, tc, device=dev).run()
        TrainLoop(cfg, replace(tc, ckpt_dir=os.path.join(tmp, "cut"), steps=lp["cut"]),
                  device=dev).run()
        resumed = TrainLoop(cfg, replace(tc, ckpt_dir=os.path.join(tmp, "cut")),
                            device=dev).run()
        steps = [m["step"] for m in resumed["history"]]
        check(steps == list(range(lp["cut"], lp["steps"])), f"resumed steps {steps}")
        worst = 0.0
        with torch.no_grad():
            for (name, a), b in zip(full["model"].named_parameters(),
                                    resumed["model"].parameters()):
                check(torch.allclose(a, b, **STEP_TOL), f"train loop: resumed {name} differs")
                worst = max(worst, float((a - b).abs().max()))
        say(f"phase train loop: TrainLoop cut after {lp['cut']} of {lp['steps']} steps and "
            f"resumed: final parameters within {STEP_TOL} of the uninterrupted run (max |diff| "
            f"{worst:.2e}); nll {full['history'][0]['nll']:.4f} -> "
            f"{full['history'][-1]['nll']:.4f}")


def run(dev, card: str) -> list[dict]:
    """The phases in order; returns the per-kernel records.  ``card`` is
    the card's name and power limit, printed beside phase serve's numbers."""
    import torch
    from repro_torch.core import build_block_store, degree_order, rmat

    gen = torch.Generator(device=dev).manual_seed(0)
    phase_kernels(dev, gen)
    ell = phase_lm_kernels(dev, gen)
    t0 = time.perf_counter()
    bwd = phase_attn_bwd(dev, gen)
    say(f"phase kernels backward: {time.perf_counter() - t0:.1f} s")

    cfg = PAGERANK
    t0 = time.perf_counter()
    g = rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"])
    t1 = time.perf_counter()
    g, _ = degree_order(g, ascending=False)
    t2 = time.perf_counter()
    store = build_block_store(g, cfg["p"])
    t3 = time.perf_counter()
    say(f"phase pagerank: graph + store {t3 - t0:.1f} s (rmat {t1 - t0:.1f}, degree order "
        f"{t2 - t1:.1f}, block store {t3 - t2:.1f}; host), n {g.n}, arcs {g.m}")
    plan, spmv, pr_res, pr_short, pr_three = phase_pagerank(dev, store)
    frontier, bfs_res = phase_bfs(dev, store, plan.schedule)
    schedule = plan.schedule
    del plan
    cc, cc_ms = phase_algorithms(dev, store)
    store._device_cache.clear()     # the streamed plans hold no in-core copy
    torch.cuda.empty_cache()
    streamed, rate, runs = phase_stream(dev, store, schedule, pr_res, pr_short, bfs_res, cc,
                                        cc_ms)
    hetero_cc = phase_hetero(dev, store, runs, rate, bfs_res, cc, cc_ms, pr_res, pr_short)
    phase_resilience(dev, store, schedule, runs, bfs_res, hetero_cc)
    t0 = time.perf_counter()
    served = phase_serve(dev, store, schedule, gen, card)
    say(f"phase serve: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh = phase_mesh(dev, store, schedule, runs, bfs_res, pr_res, pr_three, card)
    store._device_cache.clear()
    mesh_s = time.perf_counter() - t0
    del store, g, schedule
    torch.cuda.empty_cache()
    tc, tc_store, tc_schedule, tc_res = phase_tc(dev)
    tc_store._device_cache.clear()
    torch.cuda.empty_cache()
    streamed["tc_tiles"], tc_single = phase_stream_tc(dev, tc_store, tc_schedule, tc_res, rate)
    stream_kernel_report(streamed)
    t0 = time.perf_counter()
    phase_mesh_tc(tc_store, tc_schedule, tc_res, tc_single, mesh, card)
    say(f"phase mesh: {mesh_s + time.perf_counter() - t0:.1f} s")
    del tc_store, tc_schedule
    torch.cuda.empty_cache()
    phase_suite(dev, card)
    torch.cuda.empty_cache()

    phase_lm_exact(dev, lm_config(n_layers=LM_EXACT["n_layers"], dtype="float32"))
    attn = phase_lm_full(dev, lm_config())
    t0 = time.perf_counter()
    phase_train_exact(dev, lm_config(n_layers=TRAIN_EXACT["n_layers"], dtype="float32"))
    say(f"phase train exact: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bwd_launches = phase_train(dev, lm_config(n_layers=TRAIN["n_layers"]), card)
    say(f"phase train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_loop(dev)
    say(f"phase train loop: {time.perf_counter() - t0:.1f} s")
    bwd_rec = record("flash_attention_bwd", bwd_launches, bwd["err"], bwd["ms"], bwd["plain_ms"],
                     bwd["nbytes"], bwd["ops"], bwd["library_ms"], rate=BF16_TC_FLOPS)
    return [spmv, frontier, tc, attn, bwd_rec, ell, *served]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    logs = _build.build_all(list(SOURCES))
    say(f"build: {len(SOURCES)} kernels in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    tensor_core_report(logs)

    kernels = run(dev, card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
