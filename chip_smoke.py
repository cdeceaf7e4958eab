#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Builds the six CUDA kernels from ``src/repro_torch/csrc`` (the five Pallas
kernels' counterparts and ``flash_attention``'s backward), holds each
against its plain PyTorch version, and drives the port's main paths at
full configuration: the graph engine through ``compile_plan(...).run()``,
the LM's inference path (all six families: dense, moe, hybrid, ssm, vlm
and audio) through ``make_prefill_step``, ``ServeEngine`` and
``launch.serve``'s loop, and its training through
``make_train_step``, ``TrainLoop`` and ``launch.train``:

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
8a. MoE exactness (``phase moe exact``): deepseek-moe-16b at full width,
   depth cut to 2 layers, float32, TF32 off, capacity factor 16 (no slot
   dropped): the kernel path routes every token as the plain path does
   (each differing token's router margin printed) and its logits equal
   the plain path's, cached decode routes and reproduces the prefill over
   16 positions, batched serving equals solo; then one forward at the
   config's own factor 1.25 prints the share of dropped slots per layer;
8b. MoE at full size (``phase moe``): deepseek-moe-16b, 28 layers, bf16,
   16.9 B seeded parameters (33.8 GB) drawn on the card:
   ``make_prefill_step(use_kernel=True)`` on 2 × 4096 tokens (28
   ``flash_attention`` launches, nll near ln V, the load-balance and
   z-loss terms, tokens/s, idle share, peak memory beside the weights),
   a profiled decode window, and ``ServeEngine`` serving 8 requests × 32
   tokens through 4 slots, ms per step beside the 9.3 ms it takes to read
   every routed expert's weights once;
8c. the hybrid and ssm families (``phase hybrid exact``, ``phase xlstm
   exact``, ``phase hybrid``, ``phase xlstm``; none reaches a hand-written
   kernel: hymba's 1024-token window fails the attention kernel's guard,
   as in the reference, and xLSTM has no attention; each checks 0
   ``flash_attention`` launches).  hymba-1.5b at full width, 2 layers,
   float32, 1 x 1152 tokens: the Mamba branch's associative scan against
   its scan (logits within LM_TOL), teacher-forced decode through the
   1024-position ring cache past its wrap against prefill, batched
   serving against solo.  xlstm-1.3b at full width, 8 layers (7 mLSTM, the
   8th an sLSTM), float32, 2 x 256: layer by layer on the same inputs
   (MLSTM_OUTLIERS says why), the chunkwise prefill's mLSTM outputs
   against the scan's and teacher-forced decode's outputs against each
   layer's sequence form; the whole stack's loss and logits gaps printed;
   batched serving against solo.  Then each model whole in bf16 (hymba 32
   layers, 1.40 B parameters; xlstm 48 layers, 1.87 B): a prefill through
   ``make_prefill_step`` under each impl (2 x 4096; xlstm's recurrent scan
   cut to 2 x 1024), a profiled run of each on a cut length, a profiled
   decode window and 8 requests served through 4 slots, ms a step beside
   the bytes a step must move (the weights it uses and the recurrent
   states read and written once).  The four phases must take at most
   SSM_SECONDS;
8d. the vlm and audio families (``phase vlm exact``, ``phase vlm``, ``phase
   whisper``; every cross-attention gate, zero at init, set to 0.5).
   llama-3.2-vision-11b at full width, depth cut to one group of 5
   layers, float32, TF32 off, 2 x 256 tokens beside 2 x 1601 seeded vision
   features: the prefill logits with the kernel (5 launches) equal those
   without, zeroing the vision features moves them, teacher-forced decode
   with the features reproduces them over 16 positions, and one
   ``make_train_step`` step with the kernels against one without from the
   same weights (loss and grad_norm within LM_TOL, every updated parameter
   within the reference's resume tolerance, 10 forward and 5 backward
   launches under remat).  Then the model whole in bf16 (40 layers in 8
   groups, 10.11 B parameters, 20.2 GB): ``make_prefill_step(use_kernel=
   True)`` on 2 x 4096 tokens beside 2 x 1601 vision features (40
   ``flash_attention`` launches, nll near ln V, tokens/s, idle share, peak
   memory beside the weights), a profiled decode window and
   ``launch.serve``'s loop (``make_serve_step``, 4 streams x 32 tokens),
   ms a step beside its bound (the weights, the features and the caches
   read once; the features' K/V products).  whisper-base whole (6 + 6
   layers, 98.0 M parameters): in float32 the decoder's 2 x 512 prefill
   against the encoder's output over 2 x 1500 frames with the kernel (6
   launches) equal to without, decode with ``memory = _run_encoder(frames)``
   reproducing it over 16 positions; in bf16 a prefill at 8 x 448 (its
   own context: no launch, by the guard), a profiled decode window and
   the serving loop with ``memory``.  The three phases must take at most
   VLM_AUDIO_SECONDS;
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
   uninterrupted run;
12. the sharded training step (``phase sharded``), in child processes so
   that this one holds no process group: one rank a card over every
   visible card, an NCCL ``(cards, 1)`` ``("data", "model")`` mesh (``(1,
   1)`` on one card).  granite-3-8b at full width, 2 layers, float32, TF32
   off, batch 2 × 256: the model sharded by ``shard_model`` (FSDP2), one
   ``make_train_step(mesh=...)`` step with the kernels against one
   ``make_train_step`` step without a mesh and without the kernels from the
   same weights and batch (loss and grad_norm within LM_TOL, every updated
   parameter, gathered, within the reference's resume tolerance), the
   kernels' launches counted (``flash_attention`` twice a layer under
   remat, its backward once); a ``TrainLoop`` checkpoint of an unsharded
   run restored onto the mesh (elastic) and stepped to the uninterrupted
   run's parameters; the same full-width 2-layer float32 config sharded
   on the same mesh decoding SHARDED["decode"] steps through
   ``make_serve_step(mesh=...)`` against a state placed by
   ``init_decode_state(..., mesh=...)``, against the unsharded decode from
   the same weights and tokens (argmax ids equal, logits within LM_TOL;
   on one card every placement is whole, so this checks the unsplit path
   only: the split heads and positions run on four cards in
   ``tools/mesh_serve_cards.py``); and ``launch.dryrun``'s traces of
   granite-3-8b × train_4k and qwen1.5-32b × decode_32k on the 16 × 16
   production mesh over a fake process group (per-device parameter and
   cache bytes, FLOPs, collective bytes by kind, the dominant term),
   traced in a child process started with the
   script, beside the kernel and LM phases.  The phase must take at most
   SHARDED_SECONDS.

The phases run in this order: the kernel checks (1), the LM phases (7-11),
then the graph phases (2-6).  The PageRank store's host build (R-MAT,
degree order, blocks: numpy work of minutes on the card's machine) runs
in a child process from the start, beside the kernel build, the kernel
checks and the LM phases, and reaches the graph phases through files in a
temporary folder; a line gives its seconds and the time waited for it.  Lines marked "[...
s into the phases]" give the run's progress.

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
#: decode steps in the profiled window of phase 6 and of phase moe
DECODE_PROFILE_STEPS = 8
MOE_ARCH = "deepseek-moe-16b"
#: phase moe exact: depth cut to 2 layers at full width, float32, TF32 off, and a
#: capacity factor that drops no slot (cap >= T needs cf >= E/K = 10.7; the
#: reference's own decode test runs its MoE smoke configs at 8.0 for the same end)
MOE_EXACT = dict(n_layers=2, batch=2, seq=256, decode=16, requests=4, new_tokens=8,
                 capacity_factor=16.0)
#: phase moe: full width and depth, bf16: a prefill of 2 x 4096, then 8 requests
#: through 4 slots, as phase 6 serves granite-3-8b
MOE_FULL = dict(batch=2, seq=4096, slots=4, cache_len=512, requests=8, new_tokens=32,
                prompt=(16, 64))
HYBRID_ARCH = "hymba-1.5b"
XLSTM_ARCH = "xlstm-1.3b"
#: phase hybrid exact: depth cut to 2 layers at full width, float32, TF32 off; one
#: sequence of 1152 tokens runs past the 1024-token window, so decode wraps the ring
HYBRID_EXACT = dict(n_layers=2, batch=1, seq=1152, requests=4, new_tokens=8)
#: phase xlstm exact: depth cut to 8 layers so that layer 7 is an sLSTM (every 8th)
XLSTM_EXACT = dict(n_layers=8, batch=2, seq=256, chunk=64, requests=4, new_tokens=8)
#: phase xlstm exact compares layer by layer, each layer's outputs against another
#: form of it on the same inputs.  The mLSTM reads out C q / max(|n.q|, e^-m), and
#: at a few positions |n.q| nearly cancels, so no two float32 evaluations agree
#: there; through a stack of 8 such layers the difference grows until the logits
#: part by thousands of LM_TOL within 128 positions, in the reference's own two
#: forms as well (ROADMAP C), and the 2 x 256 loss by more than its rtol 1e-4 (1.4e-4
#: between the port's forms on the H100).  A fault in the carried state or the
#: chunking would move most positions, so each layer's median position must lie
#: within a tenth of LM_TOL and at most this share of its positions beyond it (at
#: full width on the CPU: medians 0.007-0.012, at most 11 of 512 positions chunked
#: vs scan and 5 decode vs scan; a fault at a few positions only, such as chunk
#: boundaries, is the CPU tests' to find, against the reference and float64); the
#: sLSTM's read-out, c / max(n, 1e-6), has no such positions: all within LM_TOL
MLSTM_OUTLIERS = 0.05
#: phase hybrid and phase xlstm: whole models in bf16, prefill_32k cut to 2 x 4096,
#: 8 requests through 4 slots, as phase lm serves granite-3-8b.  `forms`: (config
#: changes, prefill length, profiled length) of each impl.  The recurrent scans issue
#: an op or more a step a layer from the host (xlstm's 2 x 4096 scan prefill: 1.25 M
#: ops, 25 s a run on the H100's host), and torch.profiler takes ~0.8 ms an op there
#: to parse its trace, so the xlstm scan's prefill is cut to 2 x 1024 and the loops
#: are profiled on their first 16-64 tokens (their per-step issue is the same at any
#: length), 2 decode steps each (`decode_profile`)
HYBRID_FULL = dict(batch=2, seq=4096, slots=4, cache_len=512, requests=8, new_tokens=32,
                   prompt=(16, 64), decode_profile=2,
                   forms=((dict(mamba_impl="scan"), 4096, 64),
                          (dict(mamba_impl="assoc"), 4096, 4096)))
XLSTM_FULL = dict(HYBRID_FULL, forms=((dict(mlstm_impl="scan"), 1024, 16),
                                      (dict(mlstm_impl="chunked"), 4096, 64)))
#: the four phases' limit together (seconds, host clock)
SSM_SECONDS = 150.0
VLM_ARCH = "llama-3.2-vision-11b"
WHISPER_ARCH = "whisper-base"
#: the cross-attention gates (zero at init, where the vlm's cross layers add
#: nothing) are set to this in every vlm and whisper phase
XATTN_GATE = 0.5
#: phase vlm exact: depth cut to one group (cross_attn_every = 5 layers) at full
#: width, float32, TF32 off, beside the config's 1601 vision tokens
VLM_EXACT = dict(n_layers=5, batch=2, seq=256, decode=16)
#: phase vlm: whole, bf16; prefill_32k cut to 2 x 4096 beside 2 x 1601 vision
#: features; launch.serve's loop over 4 streams x 32 tokens
VLM_FULL = dict(batch=2, seq=4096, slots=4, cache_len=512, tokens=32)
#: phase whisper: the exactness prefill at 512 decoder tokens (a multiple of 128 at
#: d_head 64, which whisper's own 448-token context is not), float32; then bf16 at
#: 8 x 448 (no launch, by the guard), its serving loop 4 streams x 32 tokens
WHISPER_EXACT = dict(batch=2, seq=512, decode=16)
WHISPER_FULL = dict(batch=8, seq=448, slots=4, cache_len=448, tokens=32)
#: the three phases' limit together (seconds, host clock)
VLM_AUDIO_SECONDS = 120.0
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
#: phase sharded: granite-3-8b at full width, 2 layers, float32, batch 2 x 256 on a
#: (cards, 1) mesh; the TrainLoop resume on the smoke config, cut after `cut` steps;
#: the full-width config's decode, `decode` steps of `decode_batch` rows a rank into a
#: `decode_cache`-slot cache
SHARDED = dict(n_layers=2, batch=2, seq=256, loop_steps=3, loop_cut=2, loop_batch=4,
               loop_seq=64, decode=16, decode_batch=2, decode_cache=32)
#: the moe family's decode on the same mesh (MOE_ARCH at full width, SHARDED's depth,
#: float32): its dispatch modes.  "manual" routes each data rank's rows alone on a
#: mesh of several cards; on one card the mesh is (1, 1) and it computes what "auto"
#: does.  No leg splits the experts over model: tests/test_torch_sharding.py (gloo)
#: and tools/moe_mesh_cards.py (four cards) check that
SHARDED_MOE_MODES = ("auto", "manual")
#: the production-mesh dry runs printed beside it: (arch, shape, multi_pod)
SHARDED_DRYRUN = ((LM_ARCH, "train_4k", False), ("qwen1.5-32b", "decode_32k", False))
#: phase sharded's limit (seconds, host clock), the wait for the dry run included
SHARDED_SECONDS = 60.0

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


def batched_equals_solo(what, cfg, model, dev, ex, seed) -> None:
    """ServeEngine's greedy outputs of ``ex``'s requests in one batch equal
    each request's solo run."""
    rng = np.random.default_rng(seed)
    reqs = [(p, ex["new_tokens"]) for p in prompts(rng, ex["requests"], 2, 8, cfg.vocab)]
    batched, _, _ = serve(cfg, model, dev, reqs, ex["requests"], 32)
    for uid, req in enumerate(reqs):
        solo, _, _ = serve(cfg, model, dev, [req], 1, 32)
        check(batched[uid].output == solo[0].output,
              f"{what}: request {uid}: batched {batched[uid].output} != solo "
              f"{solo[0].output}")
    say(f"{what}: ServeEngine greedy outputs of {len(reqs)} batched requests equal their "
        f"solo runs")


def prefill_runs(what, cfg, model, dev, fu, gen, first=None, flash=None, tokens=None,
                 extra=None):
    """make_prefill_step with the kernel on a seeded batch of ``fu``'s shape
    (or on ``tokens``; ``extra`` joins the batch: ``vision`` or ``frames``):
    a first run (inside ``first``, a context manager,
    when given), whose launches are counted and checked (flash_attention
    ``flash`` times, by default once per layer) and whose metrics are
    checked (finite, nll within LOSS_BAND of ln V), then a second run timed
    on the host clock.  Returns (tokens, the first run's metrics as floats,
    its launches, both runs' seconds)."""
    import contextlib

    import torch
    from repro_torch.kernels import registry
    from repro_torch.models.steps import make_prefill_step

    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (fu["batch"], fu["seq"]), generator=gen,
                               device=dev)
    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1), **(extra or {}))
    step = make_prefill_step(cfg, use_kernel=True)
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    with first or contextlib.nullcontext():
        metrics = {k: float(v) for k, v in step(model, batch).items()}
    first_s = time.perf_counter() - t0
    launches = registry.launch_counts()
    flash = cfg.n_layers if flash is None else flash
    check(launches["flash_attention"] == flash,
          f"{what}: launched flash_attention {launches['flash_attention']} times, not {flash}")
    ln_v = float(np.log(cfg.vocab))
    check(all(np.isfinite(v) for v in metrics.values())
          and abs(metrics["nll"] - ln_v) <= LOSS_BAND,
          f"{what}: metrics {metrics}, nll not within {LOSS_BAND} of ln V = {ln_v:.3f}")
    t0 = time.perf_counter()
    step(model, batch)
    torch.cuda.synchronize()
    return tokens, metrics, launches, first_s, time.perf_counter() - t0


def prefill_profile(what, cfg, model, tokens, note="", extra=None) -> None:
    """One more prefill of ``tokens`` (``extra`` beside them) under
    torch.profiler: wall and busy ms, idle share, the busiest kernels."""
    from repro_torch.models.steps import make_prefill_step

    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1), **(extra or {}))
    step = make_prefill_step(cfg, use_kernel=True)
    _, wall, busy, top = device_profile(lambda: step(model, batch))
    if busy is None:
        say(f"{what}: device time not measured ({top})")
    else:
        say(f"{what}: profiled run {wall:.1f} ms wall, device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.3f}); busiest kernels {top}{note}")


def profiled_decode(what, cfg, model, dev, fu, note="", extra=None) -> None:
    """A warm window of decode steps of ``fu``'s slots (``fu["decode_profile"]``,
    by default DECODE_PROFILE_STEPS; ``extra``: decode_step's ``vision`` or
    ``memory``) under torch.profiler: wall and device-busy ms per step,
    idle share."""
    import torch
    from repro_torch.models import lm

    with torch.inference_mode():
        state = lm.init_decode_state(cfg, fu["slots"], fu["cache_len"], device=dev)
        toks = torch.zeros(fu["slots"], dtype=torch.int32, device=dev)

        n = fu.get("decode_profile", DECODE_PROFILE_STEPS)

        def decode():
            nonlocal state
            for _ in range(n):
                logits, state = lm.decode_step(cfg, model, state, toks, **(extra or {}))
            return logits

        decode()                      # warm
        _, wall, busy, top = device_profile(decode)
    if busy is None:
        say(f"{what}: device time not measured ({top})")
    else:
        say(f"{what}: profiled {n} steps of {fu['slots']} slots, {wall / n:.2f} ms wall per "
            f"step, device busy {busy / n:.2f} ms per step (idle share {1 - busy / wall:.3f}"
            f"{note}); busiest kernels {top}")


def serve_requests(what, cfg, model, dev, fu):
    """``fu``'s requests through ServeEngine, each checked to finish with
    all its new tokens.  Returns (steps, seconds, new tokens, request count)."""
    import torch

    rng = np.random.default_rng(0)
    lo, hi = fu["prompt"]
    reqs = [(p, fu["new_tokens"]) for p in prompts(rng, fu["requests"], lo, hi, cfg.vocab)]
    torch.cuda.reset_peak_memory_stats(dev)
    done, steps, serve_s = serve(cfg, model, dev, reqs, fu["slots"], fu["cache_len"])
    check(len(done) == len(reqs) and all(r.done and not r.truncated
                                         and len(r.output) == fu["new_tokens"]
                                         for r in done.values()),
          f"{what}: ServeEngine did not finish every request")
    return steps, serve_s, sum(len(r.output) for r in done.values()), len(reqs)


def teacher_forced(what, cfg, model, dev, tokens, want, steps, **extra) -> float:
    """Decode over the first ``steps`` positions of ``tokens`` with ``extra``
    (``vision`` or ``memory``), each position's logits within LM_TOL of the
    prefill's ``want``; returns the largest difference."""
    import torch
    from repro_torch.models import lm

    err = 0.0
    with torch.inference_mode():
        state = lm.init_decode_state(cfg, tokens.shape[0], steps, device=dev)
        for t in range(steps):
            logits, state = lm.decode_step(cfg, model, state, tokens[:, t], **extra)
            err = max(err, float((logits - want[:, t]).abs().max()))
            check(torch.allclose(logits, want[:, t], **LM_TOL),
                  f"{what}: decode logits at position {t} vs prefill: max err {err}")
    return err


def kernel_vs_plain(what, cfg, model, batch, launches_want):
    """forward_logits with the kernel (``launches_want`` flash_attention
    launches) against without, within LM_TOL.  Returns (the kernel path's
    logits, max err, launches)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm

    with torch.inference_mode():
        registry.reset_launch_counts()
        got = lm.forward_logits(cfg, model, batch, use_kernel=True)
        launches = registry.launch_counts()["flash_attention"]
        check(launches == launches_want,
              f"{what}: flash_attention launches {launches} != {launches_want}")
        want = lm.forward_logits(cfg, model, batch, use_kernel=False)
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and torch.allclose(got, want, **LM_TOL),
              f"{what}: logits, kernel vs plain: max err {err}")
    return got, err, launches


def phase_lm_exact(dev, cfg) -> None:
    """The kernel path against the plain path, decode against prefill, and
    batched serving against solo serving, all in float32."""
    import torch
    from repro_torch.models import lm

    ex = LM_EXACT
    gen = torch.Generator(device=dev).manual_seed(1)
    model = lm.LM(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (ex["batch"], ex["seq"]), generator=gen, device=dev)
    got, err, launches = kernel_vs_plain("lm exact", cfg, model, dict(tokens=tokens),
                                         cfg.n_layers)
    derr = teacher_forced("lm exact", cfg, model, dev, tokens, got, ex["decode"])
    say(f"phase lm exact: {cfg.name} {cfg.n_layers} layers float32, logits "
        f"{tuple(got.shape)}: kernel vs plain max err {err:.2e}, decode vs prefill over "
        f"{ex['decode']} positions max err {derr:.2e} (atol {LM_TOL['atol']}, rtol "
        f"{LM_TOL['rtol']}), launches {launches}")
    del got

    batched_equals_solo("phase lm exact", cfg, model, dev, ex, seed=1)
    del model
    torch.cuda.empty_cache()


def phase_lm_full(dev, cfg):
    """The whole model in bf16: prefill with the kernel, then serving.
    Returns flash_attention's record, timed on layer 0's q, k, v."""
    import torch
    from repro_torch.models import lm

    fu = LM_FULL
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm.LM(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"phase lm: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {n_params / 1e9:.3f} B "
        f"parameters drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"memory allocated {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    tokens, metrics, launches, first_s, prefill_s = prefill_runs("phase lm prefill", cfg,
                                                                 model, dev, fu, gen)
    b, s = tokens.shape
    say(f"phase lm prefill: B={b} S={s}, loss {metrics['loss']:.4f} (ln V "
        f"{np.log(cfg.vocab):.4f}), first run {first_s:.3f} s, second {prefill_s:.3f} s "
        f"({b * s / prefill_s:.0f} tokens/s, host clock), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, launches {launches}")
    prefill_profile("phase lm prefill", cfg, model, tokens)

    profiled_decode("phase lm decode", cfg, model, dev, fu)
    steps, serve_s, new_tokens, n_reqs = serve_requests("phase lm serve", cfg, model, dev, fu)
    say(f"phase lm serve: {n_reqs} requests (prompts {fu['prompt'][0]}-{fu['prompt'][1]} "
        f"tokens, {fu['new_tokens']} new each) through {fu['slots']} slots, cache "
        f"{fu['cache_len']}: {steps} decode steps in {serve_s:.2f} s, "
        f"{serve_s * 1e3 / steps:.2f} ms per step, {new_tokens / serve_s:.1f} generated "
        f"tokens/s, max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    rec = layer0_attention_record("flash_attention", cfg, model, tokens,
                                  launches["flash_attention"])
    del model
    torch.cuda.empty_cache()
    return rec


def layer0_attention_record(name, cfg, model, tokens, launches, h=None):
    """flash_attention checked and timed on layer 0's q, k, v of a prefill of
    ``tokens`` (S_q = S_k, causal), beside its plain version and SDPA.
    ``h`` is layer 0's input where it is not the embeddings (the vlm's
    first cross block comes before it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import attention
    from repro_torch.models.common import rms_norm

    b, s = tokens.shape
    layer = model.layers[0]
    with torch.inference_mode():
        x = rms_norm(F.embedding(tokens, model.embed) if h is None else h, layer.ln1)
        q, k, v = (t.transpose(1, 2).contiguous() for t in attention.project_qkv(
            layer.attn, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta))
        del x
        err, share = attn_error(flash_attention_cuda(q, k, v), q, k, v)
        check(share <= 1.0, f"{name} on layer 0's inputs: max err {err}, "
              f"{share:.3f} of the tolerance {ATTN_TOL[cfg.dtype]}")
        say(f"  {name} on layer 0's inputs: max err {err:.2e}, {share:.3f} of the "
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
        rec = record(name, launches, err,
                     cuda_ms(lambda: flash_attention_cuda(q, k, v), 5),
                     cuda_ms(lambda: ref.attention_ref(q, k, v), 2),
                     nbytes, 4.0 * cfg.d_head * pairs, library, rate=BF16_TC_FLOPS,
                     kernel="flash_attention")
    say(f"  {name} timed on layer 0's q {tuple(q.shape)}, k, v {tuple(k.shape)} "
        f"{cfg.dtype}: {4.0 * cfg.d_head * pairs / rec['ms'] / 1e9:.1f} TFLOP/s")
    return rec


def moe_config(**changes):
    from dataclasses import replace

    from repro_torch.configs import get_config

    return replace(get_config(MOE_ARCH), **changes)


class MoeRoutes:
    """Within ``with``: each MoE call's route (experts per token, in order)
    and the margin between each token's K-th and (K+1)-th router
    probabilities, from ``repro_torch.models.moe.route``, and each call's
    dropped slots and slot count from ``moe.slots``."""

    def __enter__(self):
        from repro_torch.models import moe

        self.idx, self.margin, self.dropped = [], [], []
        self._mod, self._route, self._slots = moe, moe.route, moe.slots

        def route(xf, router, top_k):
            out = self._route(xf, router, top_k)
            top = out[1].topk(top_k + 1, dim=-1).values
            self.idx.append(out[3])
            self.margin.append(top[:, top_k - 1] - top[:, top_k])
            return out

        def slots(idx, n_experts, cap, groups=1):
            keep, slot = self._slots(idx, n_experts, cap, groups)
            self.dropped.append(((~keep).sum(), keep.numel()))
            return keep, slot

        moe.route, moe.slots = route, slots
        return self

    def __exit__(self, *exc):
        self._mod.route, self._mod.slots = self._route, self._slots

    def drop_shares(self) -> list[float]:
        return [int(n) / total for n, total in self.dropped]


def same_routes(what, got_idx, want_idx, margins) -> None:
    """Fail unless two runs routed every token alike; print each differing
    token's margin between its K-th and (K+1)-th router probabilities."""
    check(len(got_idx) == len(want_idx) > 0,
          f"{what}: {len(got_idx)} MoE calls against {len(want_idx)}")
    for layer, (a, b, m) in enumerate(zip(got_idx, want_idx, margins)):
        bad = (a != b).any(-1).nonzero()[:, 0].tolist()
        if bad:
            say(f"  {what}: layer {layer} routes {len(bad)} tokens differently; their "
                f"K-th minus (K+1)-th probabilities: "
                f"{[(t, float(m[t])) for t in bad[:20]]}")
        check(not bad, f"{what}: layer {layer} routes tokens {bad[:20]} differently")


def phase_moe_exact(dev, cfg) -> None:
    """deepseek-moe-16b at full width, MOE_EXACT's depth, float32 and a
    capacity factor that drops no slot: the kernel path against the plain
    path (routes first, then logits), decode against prefill, batched
    serving against solo; then the dropped share at the config's own
    factor."""
    from dataclasses import replace

    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm

    ex = MOE_EXACT
    gen = torch.Generator(device=dev).manual_seed(3)
    model = lm.LM(cfg, generator=gen, device=dev)
    b, s = ex["batch"], ex["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    with torch.inference_mode():
        registry.reset_launch_counts()
        with MoeRoutes() as kr:
            got = lm.forward_logits(cfg, model, dict(tokens=tokens), use_kernel=True)
        launches = registry.launch_counts()["flash_attention"]
        check(launches == cfg.n_layers,
              f"moe exact: flash_attention launches {launches} != {cfg.n_layers} layers")
        check(not any(kr.drop_shares()), f"moe exact: cf {cfg.capacity_factor} dropped slots "
              f"{kr.drop_shares()}")
        with MoeRoutes() as pr:
            want = lm.forward_logits(cfg, model, dict(tokens=tokens), use_kernel=False)
        same_routes("moe exact, kernel vs plain", kr.idx, pr.idx, kr.margin)
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and torch.allclose(got, want, **LM_TOL),
              f"moe exact: logits, kernel vs plain: max err {err}")
        state = lm.init_decode_state(cfg, b, ex["decode"], device=dev)
        derr = 0.0
        for t in range(ex["decode"]):
            with MoeRoutes() as dr:
                logits, state = lm.decode_step(cfg, model, state, tokens[:, t])
            rows = torch.arange(b, device=dev) * s + t      # token (i, t) of the prefill
            same_routes(f"moe exact, decode position {t} vs prefill", dr.idx,
                        [i[rows] for i in kr.idx], dr.margin)
            derr = max(derr, float((logits - got[:, t]).abs().max()))
            check(torch.allclose(logits, got[:, t], **LM_TOL),
                  f"moe exact: decode logits at position {t} vs prefill: max err {derr}")
        tight = min(float(m.min()) for m in kr.margin)
    say(f"phase moe exact: {cfg.name} {cfg.n_layers} layers float32, capacity factor "
        f"{cfg.capacity_factor} (no slot dropped), logits {tuple(got.shape)}: routes equal, "
        f"kernel vs plain max err {err:.2e}, decode vs prefill over {ex['decode']} positions "
        f"max err {derr:.2e} (atol {LM_TOL['atol']}, rtol {LM_TOL['rtol']}), launches "
        f"{launches}; smallest K-th minus (K+1)-th router probability {tight:.2e}")
    del got, want, state

    batched_equals_solo("phase moe exact", cfg, model, dev, ex, seed=3)

    own = replace(cfg, capacity_factor=moe_config().capacity_factor)
    with torch.inference_mode(), MoeRoutes() as r:
        lm.forward_logits(own, model, dict(tokens=tokens), use_kernel=True)
    say(f"phase moe exact: at the config's capacity factor {own.capacity_factor} (cap "
        f"{moe_capacity(own, b * s)} of {b * s} tokens x {own.top_k} slots over "
        f"{own.n_experts} experts) the share of dropped slots per layer "
        f"{[round(x, 4) for x in r.drop_shares()]}")
    del model
    torch.cuda.empty_cache()


def moe_capacity(cfg, t: int) -> int:
    from repro_torch.models.moe import capacity

    return capacity(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor, cfg.moe_dispatch_sharding)


def phase_moe_full(dev, cfg, card: str):
    """deepseek-moe-16b at full width and depth in bf16: a prefill with the
    kernel through make_prefill_step (forward_loss with its aux terms),
    a profiled window of decode steps, and ServeEngine serving MOE_FULL's
    requests.  Returns flash_attention's record on this path."""
    import torch
    from repro_torch.models import lm

    fu = MOE_FULL
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm.LM(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"phase moe: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {n_params / 1e9:.3f} B "
        f"parameters ({weights / 1e9:.2f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s, memory allocated "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB [{card}]")
    routes = MoeRoutes()             # the first run's routes and drops
    tokens, metrics, launches, first_s, prefill_s = prefill_runs(
        "phase moe prefill", cfg, model, dev, fu, gen, first=routes)
    shares = routes.drop_shares()
    b, s = tokens.shape
    say(f"phase moe prefill: B={b} S={s}, capacity {moe_capacity(cfg, b * s)} a expert, nll "
        f"{metrics['nll']:.4f} (ln V {np.log(cfg.vocab):.4f}), load_balance "
        f"{metrics['load_balance']:.4f} and z_loss {metrics['z_loss']:.4f} summed over "
        f"{cfg.n_layers} layers, loss {metrics['loss']:.4f}; first run {first_s:.3f} s, second "
        f"{prefill_s:.3f} s ({b * s / prefill_s:.0f} tokens/s, host clock); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB beside "
        f"{weights / 1e9:.2f} GB of weights; launches {launches}; dropped slots per layer min "
        f"{min(shares):.4f}, mean {np.mean(shares):.4f}, max {max(shares):.4f} [{card}]")
    prefill_profile("phase moe prefill", cfg, model, tokens, note=f" [{card}]")

    # every routed expert's weights are read each step: the reference runs all
    # E experts on their capacity buffers, cap >= 1 even at 4 tokens
    expert_bytes = sum(p.numel() * p.element_size() for layer in model.layers
                       for p in (layer.moe.w_gate, layer.moe.w_up, layer.moe.w_down))
    bound_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    profiled_decode("phase moe decode", cfg, model, dev, fu,
                    note=f"; bound {bound_ms:.2f} ms [{card}]")
    steps, serve_s, new_tokens, n_reqs = serve_requests("phase moe serve", cfg, model, dev, fu)
    say(f"phase moe serve: {n_reqs} requests (prompts {fu['prompt'][0]}-{fu['prompt'][1]} "
        f"tokens, {fu['new_tokens']} new each) through {fu['slots']} slots, cache "
        f"{fu['cache_len']}: {steps} decode steps in {serve_s:.2f} s, "
        f"{serve_s * 1e3 / steps:.2f} ms per step against a weight-read bound of "
        f"{bound_ms:.2f} ms ({expert_bytes / 1e9:.2f} GB of routed experts at 3.35 TB/s), "
        f"{new_tokens / serve_s:.1f} generated tokens/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB [{card}]")

    rec = layer0_attention_record("flash_attention[moe prefill]", cfg, model, tokens,
                                  launches["flash_attention"])
    del model
    torch.cuda.empty_cache()
    return rec


def arch_config(arch: str, **changes):
    """The registry's full configuration of ``arch`` with ``changes``."""
    from dataclasses import replace

    from repro_torch.configs import get_config

    return replace(get_config(arch), **changes)


def no_flash(what, launches) -> None:
    """The hybrid and ssm paths never reach flash_attention: a sliding window
    fails the reference's guard (models/attention.py:141), xLSTM has no
    attention."""
    check(launches["flash_attention"] == 0,
          f"{what}: flash_attention launched {launches['flash_attention']} times, expected 0")


def decode_errors(cfg, model, dev, tokens, want):
    """Teacher-forced decode over every position of ``tokens`` (B,S) from a
    fresh state of S positions: the largest |logits - want[:, t]| and the
    largest share of LM_TOL used, over all positions (one sync at the end)."""
    import torch
    from repro_torch.models import lm

    b, s = tokens.shape
    state = lm.init_decode_state(cfg, b, s, device=dev)
    errs, shares = [], []
    for t in range(s):
        logits, state = lm.decode_step(cfg, model, state, tokens[:, t])
        diff = (logits - want[:, t]).abs()
        errs.append(diff.max())
        shares.append((diff / (LM_TOL["atol"] + LM_TOL["rtol"] * want[:, t].abs())).max())
    check(int(state["pos"]) == s, f"decode ended at position {int(state['pos'])}, not {s}")
    return float(torch.stack(errs).max()), float(torch.stack(shares).max()), state


def phase_hybrid_exact(dev, cfg) -> None:
    """hymba-1.5b at full width, HYBRID_EXACT's depth, float32: the Mamba
    branch's scan against its associative scan, decode past the ring
    cache's wrap against prefill, batched serving against solo."""
    from dataclasses import replace

    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm

    ex = HYBRID_EXACT
    gen = torch.Generator(device=dev).manual_seed(5)
    model = lm.LM(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (ex["batch"], ex["seq"]), generator=gen, device=dev)
    with torch.inference_mode():
        registry.reset_launch_counts()
        want = lm.forward_logits(replace(cfg, mamba_impl="scan"), model, dict(tokens=tokens),
                                 use_kernel=True)
        assoc = lm.forward_logits(replace(cfg, mamba_impl="assoc"), model, dict(tokens=tokens),
                                  use_kernel=True)
        no_flash("phase hybrid exact, prefill", registry.launch_counts())
        err = float((assoc - want).abs().max())
        check(bool(torch.isfinite(want).all()) and torch.allclose(assoc, want, **LM_TOL),
              f"hybrid exact: logits, assoc vs scan: max err {err}")
        del assoc
        registry.reset_launch_counts()
        derr, share, state = decode_errors(cfg, model, dev, tokens, want)
        no_flash("phase hybrid exact, decode", registry.launch_counts())
        ring = state["cache"]["k"].shape[2]
        check(ring == cfg.attn_window < ex["seq"], f"hybrid exact: ring of {ring} positions")
        check(share <= 1.0, f"hybrid exact: decode vs prefill over {ex['seq']} positions: max "
              f"err {derr}, {share:.3f} of LM_TOL")
    say(f"phase hybrid exact: {cfg.name} {cfg.n_layers} layers float32, logits "
        f"{tuple(want.shape)}: assoc vs scan max err {err:.2e}; decode vs prefill over "
        f"{ex['seq']} positions through a ring of {ring} (wrapped at {ring}) max err "
        f"{derr:.2e}, {share:.3f} of LM_TOL (atol {LM_TOL['atol']}, rtol {LM_TOL['rtol']}); "
        f"flash_attention launches 0")
    del want, state
    batched_equals_solo("phase hybrid exact", cfg, model, dev, ex, seed=5)
    del model
    torch.cuda.empty_cache()


class LayerTaps:
    """Within ``with``: each xLSTM block's input and output, per layer in
    call order, from the functions of ``repro_torch.models.lm`` named in
    ``names`` (looked up there at call time; each layer calls one of them)."""

    def __init__(self, n_layers: int, names):
        self.names = names
        self.x = [[] for _ in range(n_layers)]
        self.y = [[] for _ in range(n_layers)]

    def __enter__(self):
        import itertools

        from repro_torch.models import lm

        self._lm, self._fns = lm, [getattr(lm, n) for n in self.names]
        layer = itertools.cycle(range(len(self.x)))

        def tap(fn):
            def call(p, x, *args, **kw):
                i = next(layer)
                res = fn(p, x, *args, **kw)
                self.x[i].append(x)
                self.y[i].append(res[0] if isinstance(res, tuple) else res)
                return res
            return call

        for n, fn in zip(self.names, self._fns):
            setattr(lm, n, tap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in zip(self.names, self._fns):
            setattr(self._lm, n, fn)

    def layer(self, i):
        """Layer i's inputs and outputs over the calls, joined along S."""
        import torch

        return torch.cat(self.x[i], 1), torch.cat(self.y[i], 1)


def layer_agreement(what, got, want, outliers: float):
    """Per position (b, t), the largest share of LM_TOL that ``got`` uses
    against ``want``: fail unless the median position uses at most a tenth
    and at most ``outliers`` of the positions exceed it.  Returns (median
    share, positions beyond, worst share)."""
    pos = ((got - want).abs() / (LM_TOL["atol"] + LM_TOL["rtol"] * want.abs())).amax(-1)
    over, median, limit = int((pos > 1).sum()), float(pos.median()), int(outliers * pos.numel())
    check(median <= 0.1 and over <= limit,
          f"{what}: median position {median:.3f} of LM_TOL, {over} of {pos.numel()} positions "
          f"beyond it (limit {limit}), worst {float(pos.max()):.3f}")
    return round(median, 4), over, round(float(pos.max()), 3)


def phase_xlstm_exact(dev, cfg) -> None:
    """xlstm-1.3b at full width, XLSTM_EXACT's depth (layer 7 an sLSTM),
    float32, layer by layer (MLSTM_OUTLIERS says why): the chunkwise
    prefill's mLSTM outputs against the scan on the same inputs; teacher-
    forced decode's step outputs against each layer's sequence form on the
    same inputs; the whole stack's loss and logits gaps printed; batched
    serving against solo."""
    from dataclasses import replace

    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm, ssm
    from repro_torch.models.steps import make_prefill_step

    ex = XLSTM_EXACT
    gen = torch.Generator(device=dev).manual_seed(6)
    model = lm.LM(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (ex["batch"], ex["seq"]), generator=gen, device=dev)
    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1))
    chunked = replace(cfg, mlstm_impl="chunked", mlstm_chunk=ex["chunk"])
    kinds = "".join("s" if lm._is_slstm(cfg, i) else "m" for i in range(cfg.n_layers))
    with torch.inference_mode():
        registry.reset_launch_counts()
        loss = {"scan": float(make_prefill_step(cfg, use_kernel=True)(model, batch)["loss"])}
        with LayerTaps(cfg.n_layers, ("mlstm_seq_chunked", "slstm_seq")) as taps:
            loss["chunked"] = float(make_prefill_step(chunked, use_kernel=True)(model, batch)["loss"])
        want = lm.forward_logits(cfg, model, dict(tokens=tokens), use_kernel=True)
        no_flash("phase xlstm exact, prefill", registry.launch_counts())
        check(all(np.isfinite(v) for v in loss.values()), f"xlstm exact: loss {loss}")
        impl = []
        for i, layer in enumerate(model.layers):
            if kinds[i] == "m":
                x, got = taps.layer(i)
                impl.append(layer_agreement(
                    f"xlstm exact: layer {i}: chunked vs scan", got,
                    ssm.mlstm_seq(layer.mlstm, x, n_heads=cfg.n_heads), MLSTM_OUTLIERS))
        del taps
        registry.reset_launch_counts()
        with LayerTaps(cfg.n_layers, ("mlstm_step", "slstm_step")) as taps:
            derr, dshare, _ = decode_errors(cfg, model, dev, tokens, want)
        no_flash("phase xlstm exact, decode", registry.launch_counts())
        dec = []
        for i, layer in enumerate(model.layers):
            x, got = taps.layer(i)
            seq = (ssm.slstm_seq(layer.slstm, x, n_heads=cfg.n_heads) if kinds[i] == "s"
                   else ssm.mlstm_seq(layer.mlstm, x, n_heads=cfg.n_heads))
            dec.append(layer_agreement(f"xlstm exact: layer {i}: decode vs its sequence form",
                                       got, seq, 0.0 if kinds[i] == "s" else MLSTM_OUTLIERS))
    rel = abs(loss["chunked"] - loss["scan"]) / abs(loss["scan"])
    say(f"phase xlstm exact: {cfg.name} {cfg.n_layers} layers ({kinds}) float32, B={ex['batch']} "
        f"S={ex['seq']}, layer by layer on the same inputs as (median position's share of "
        f"LM_TOL, positions beyond it of {ex['batch'] * ex['seq']}, worst share): the mLSTM "
        f"layers' chunked ({ex['chunk']}) vs scan {impl}; each layer's decode vs its sequence "
        f"form {dec}.  The whole stack (not checks: float32 rounding grows through it, "
        f"MLSTM_OUTLIERS): loss scan {loss['scan']:.6f}, chunked {loss['chunked']:.6f}, rel "
        f"{rel:.2e}; decode vs prefill logits max err {derr:.2e}, {dshare:.3f} of LM_TOL; "
        f"flash_attention launches 0")
    del want, taps
    batched_equals_solo("phase xlstm exact", cfg, model, dev, ex, seed=6)
    del model
    torch.cuda.empty_cache()


def decode_bound(cfg, model, fu) -> tuple[float, float]:
    """The bytes a decode step of ``fu``'s slots must move at least, and their
    time at 3.35 TB/s: each weight the step uses read once (every layer's, the
    head; of the embedding only the slots' rows; an ssm layer only the branch it
    runs) and the recurrent states read and written once (KV caches left out)."""
    import torch
    from repro_torch.models import lm

    def nbytes(mod):
        return sum(p.numel() * p.element_size() for p in mod.parameters())

    b = fu["slots"]
    weights = sum(p.numel() * p.element_size() for p in (model.final_norm, model.head()))
    weights += b * cfg.d_model * model.embed.element_size()
    state = 0
    with torch.inference_mode():
        st = lm.init_decode_state(cfg, b, 1, device=model.device)["cache"]
    for i, layer in enumerate(model.layers):
        if cfg.family == "ssm":
            name = "slstm" if lm._is_slstm(cfg, i) else "mlstm"
            weights += layer.ln1.numel() * layer.ln1.element_size() + nbytes(getattr(layer, name))
            state += 2 * sum(t[i].numel() * t[i].element_size() for t in st[name].values())
        else:
            weights += nbytes(layer)
            state += 2 * sum(st[k][i].numel() * st[k][i].element_size()
                             for k in ("mamba_h", "mamba_conv"))
    return weights + state, (weights + state) / HBM_BYTES_PER_S * 1e3


def phase_ssm_full(what, dev, cfg, fu, card: str) -> None:
    """A hybrid or ssm model whole in bf16: a prefill through
    make_prefill_step under each of ``fu``'s forms, each with a profiled
    run, then a profiled decode window and ServeEngine serving ``fu``'s
    requests, ms a step beside decode_bound."""
    from dataclasses import replace

    import torch
    from repro_torch.models import lm

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm.LM(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    f32 = sum(p.numel() * p.element_size() for p in model.parameters()
              if p.dtype == torch.float32)
    say(f"phase {what}: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {n_params / 1e9:.3f} B "
        f"parameters ({weights / 1e9:.3f} GB, {f32 / 1e9:.3f} GB of it float32) drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s, memory allocated "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB [{card}]")
    full = torch.randint(0, cfg.vocab, (fu["batch"], fu["seq"]), generator=gen, device=dev)
    for impl, seq, profile_seq in fu["forms"]:
        c = replace(cfg, **impl)
        form = "/".join(str(v) for v in impl.values())
        tokens, metrics, launches, first_s, prefill_s = prefill_runs(
            f"phase {what} prefill ({form})", c, model, dev, fu, gen, flash=0,
            tokens=full[:, :seq])
        b, s = tokens.shape
        say(f"phase {what} prefill ({form}): B={b} S={s}, nll {metrics['nll']:.4f} (ln V "
            f"{np.log(cfg.vocab):.4f}); first run {first_s:.3f} s, second {prefill_s:.3f} s "
            f"({b * s / prefill_s:.0f} tokens/s, host clock); max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB beside {weights / 1e9:.2f} GB "
            f"of weights; flash_attention launches {launches['flash_attention']} [{card}]")
        cut = tokens[:, :profile_seq]
        prefill_profile(f"phase {what} prefill ({form})", c, model, cut,
                        note=f" (B={b} S={cut.shape[1]}) [{card}]")
    nbytes, bound_ms = decode_bound(cfg, model, fu)
    profiled_decode(f"phase {what} decode", cfg, model, dev, fu,
                    note=f"; bound {bound_ms:.2f} ms [{card}]")
    steps, serve_s, new_tokens, n_reqs = serve_requests(f"phase {what} serve", cfg, model, dev,
                                                        fu)
    say(f"phase {what} serve: {n_reqs} requests (prompts {fu['prompt'][0]}-{fu['prompt'][1]} "
        f"tokens, {fu['new_tokens']} new each) through {fu['slots']} slots, cache "
        f"{fu['cache_len']}: {steps} decode steps in {serve_s:.2f} s, "
        f"{serve_s * 1e3 / steps:.2f} ms per step against a bound of {bound_ms:.2f} ms "
        f"({nbytes / 1e9:.3f} GB of weights and recurrent state at 3.35 TB/s), "
        f"{new_tokens / serve_s:.1f} generated tokens/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB [{card}]")
    del model
    torch.cuda.empty_cache()


def phase_ssm(dev, card: str) -> None:
    """The four hybrid and ssm phases in order, each timed; together within
    SSM_SECONDS."""
    start = time.perf_counter()
    ex, xe = HYBRID_EXACT, XLSTM_EXACT
    phases = (
        ("hybrid exact", lambda: phase_hybrid_exact(
            dev, arch_config(HYBRID_ARCH, n_layers=ex["n_layers"], dtype="float32"))),
        ("xlstm exact", lambda: phase_xlstm_exact(
            dev, arch_config(XLSTM_ARCH, n_layers=xe["n_layers"], dtype="float32"))),
        ("hybrid", lambda: phase_ssm_full("hybrid", dev, arch_config(HYBRID_ARCH), HYBRID_FULL,
                                          card)),
        ("xlstm", lambda: phase_ssm_full("xlstm", dev, arch_config(XLSTM_ARCH), XLSTM_FULL,
                                         card)),
    )
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        say(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    total = time.perf_counter() - start
    check(total <= SSM_SECONDS, f"the hybrid and ssm phases took {total:.1f} s, more than "
          f"{SSM_SECONDS:.0f} s")
    say(f"phases hybrid exact, xlstm exact, hybrid, xlstm: {total:.1f} s (limit "
        f"{SSM_SECONDS:.0f} s)")


def set_gates(model, value: float) -> None:
    """Every cross-attention gate of ``model`` (the vlm's ``xattn``, the audio
    decoder's ``dec_xattn``, which it does not read) set to ``value``: at
    init they are zero and the vlm's cross layers add nothing."""
    import torch

    with torch.no_grad():
        for name in ("xattn", "dec_xattn"):
            for block in getattr(model, name, ()):
                block.attn.gate.fill_(value)


def phase_vlm_exact(dev, cfg) -> None:
    """llama-3.2-vision-11b at full width, one group (VLM_EXACT's depth),
    float32, gates at XATTN_GATE: the kernel path against the plain path,
    the logits' dependence on the vision features, decode with them against
    prefill, and one make_train_step step with the kernels against one
    without from the same weights."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw_init

    ex = VLM_EXACT

    def seeded():
        m = lm.LM(cfg, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        set_gates(m, XATTN_GATE)
        return m

    model = seeded()
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s = ex["batch"], ex["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    vision = torch.randn((b, cfg.vision_tokens, cfg.d_model), generator=gen, device=dev)
    got, err, launches = kernel_vs_plain("vlm exact", cfg, model,
                                         dict(tokens=tokens, vision=vision), cfg.n_layers)
    with torch.inference_mode():
        other = lm.forward_logits(cfg, model, dict(tokens=tokens, vision=torch.zeros_like(vision)),
                                  use_kernel=True)
        moved = float((other - got).abs().max())
    del other
    check(moved > 1e-2, f"vlm exact: logits move by {moved} when the vision features are zeroed")
    derr = teacher_forced("vlm exact", cfg, model, dev, tokens, got, ex["decode"], vision=vision)
    say(f"phase vlm exact: {cfg.name} {cfg.n_layers} layers ({len(model.xattn)} group) float32, "
        f"{n_params / 1e9:.3f} B parameters, gates {XATTN_GATE}, vision {tuple(vision.shape)}, "
        f"logits {tuple(got.shape)}: kernel vs plain max err {err:.2e}, decode vs prefill over "
        f"{ex['decode']} positions max err {derr:.2e} (atol {LM_TOL['atol']}, rtol "
        f"{LM_TOL['rtol']}), launches {launches}; zeroing the vision features moves the logits "
        f"by up to {moved:.3f}")
    del got, model
    torch.cuda.empty_cache()

    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1), vision=vision)
    runs = {}
    for use_kernel in (False, True):     # the plain run's parameters and mu are kept
        model = seeded()
        opt = adamw_init(model)
        registry.reset_launch_counts()
        opt, m = make_train_step(cfg, warmup_steps=1, use_kernel=use_kernel)(model, opt, batch, 0)
        runs[use_kernel] = model, dict(mu=opt["mu"]), {k: float(v) for k, v in m.items()}, \
            registry.launch_counts()
        del opt, m
        torch.cuda.empty_cache()
    (km, _, kmet, kl), (pm, popt, pmet, pl) = runs[True], runs[False]
    check(kl["flash_attention"] == 2 * cfg.n_layers and kl["flash_attention_bwd"] == cfg.n_layers
          and pl["flash_attention"] == pl["flash_attention_bwd"] == 0,
          f"vlm exact: train launches with the kernels {kl}, without {pl}")
    for key in ("loss", "grad_norm"):
        check(np.isfinite(kmet[key]) and np.isclose(kmet[key], pmet[key], **LM_TOL),
              f"vlm exact: {key} with the kernels {kmet[key]}, without {pmet[key]}")
    worst, worst_tiny, tiny = updated_params_match(km, pm, popt, kmet["lr"])
    gates = [float(blk.attn.gate.detach()) for blk in km.xattn]
    check(all(g != XATTN_GATE for g in gates), f"vlm exact: the gates did not move: {gates}")
    say(f"phase vlm exact: one train step at {b} x {s}: loss {kmet['loss']:.6f} vs "
        f"{pmet['loss']:.6f} without the kernels, grad_norm {kmet['grad_norm']:.6f} vs "
        f"{pmet['grad_norm']:.6f} ({LM_TOL}); updated parameters max |diff| {worst:.2e} "
        f"({STEP_TOL}), and {worst_tiny:.2e} on the {tiny} elements with 0 < |g| < 1e-6; gates "
        f"after the step {gates}; launches {kl}")
    del runs, km, pm, popt, model
    torch.cuda.empty_cache()


def serve_loop(what, cfg, model, fu, extra, nbytes, ops, card: str) -> None:
    """launch.serve's loop (make_serve_step, greedy) over ``fu``'s streams and
    tokens with ``extra`` in every step's batch: ms a step beside the bound of
    ``nbytes`` at 3.35 TB/s and ``ops`` at 989 TFLOP/s."""
    import torch
    from repro_torch.launch.serve import generate

    kw = dict(batch=fu["slots"], tokens=fu["tokens"], cache_len=fu["cache_len"], extra=extra)
    generate(cfg, model, **dict(kw, tokens=2))            # warm
    torch.cuda.reset_peak_memory_stats(model.device)
    seq, secs = generate(cfg, model, **kw)
    check(tuple(seq.shape) == (fu["slots"], fu["tokens"])
          and bool(((seq >= 0) & (seq < cfg.vocab)).all()),
          f"{what}: generated ids {tuple(seq.shape)} out of range")
    ms = secs * 1e3 / fu["tokens"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_TC_FLOPS * 1e3
    say(f"{what}: launch.serve's loop, {fu['slots']} streams x {fu['tokens']} tokens (cache "
        f"{fu['cache_len']}): {secs:.2f} s, {ms:.2f} ms per step against a bound of "
        f"{max(t_bytes, t_ops):.2f} ms ({nbytes / 1e9:.3f} GB of weights, features and caches "
        f"read once at 3.35 TB/s: {t_bytes:.2f} ms; the features' K/V products {ops / 1e12:.3f} "
        f"TFLOP at 989 TFLOP/s: {t_ops:.2f} ms; {t_bytes + t_ops:.2f} ms if they do not "
        f"overlap), {fu['slots'] * fu['tokens'] / secs:.1f} generated tokens/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(model.device) / 1e9:.2f} GB, "
        f"first stream {seq[0, :8].tolist()} [{card}]")


def cross_decode_bound(cfg, model, slots, cache_len, feats, blocks):
    """(bytes, operations) a decode step must at least move and do: every
    weight it uses read once (the embedding only the slots' rows; not the
    encoder's, which runs once a request), the cross features read by each
    of ``blocks`` cross layers and every KV cache read once; the features'
    K and V products in those layers."""
    b, t = slots, feats
    elt = model.embed.element_size()
    weights = sum(p.numel() * p.element_size() for name, p in model.named_parameters()
                  if name != "embed" and not name.startswith(("encoder.", "enc_")))
    weights += b * cfg.d_model * elt
    kv = cfg.n_kv_heads * cfg.d_head
    caches = 2 * cfg.n_layers * b * cache_len * kv * elt
    features = blocks * b * t * cfg.d_model * elt
    ops = blocks * 2 * (2.0 * b * t * cfg.d_model * kv)
    return weights + caches + features, ops


def phase_vlm_full(dev, cfg, card: str):
    """llama-3.2-vision-11b whole in bf16 (gates at XATTN_GATE): a prefill
    through make_prefill_step with the kernel beside seeded vision
    features, a profiled decode window, launch.serve's loop.  Returns
    flash_attention's record on this path (layer 0's q, k, v)."""
    import torch
    from repro_torch.models import lm

    fu = VLM_FULL
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm.LM(cfg, generator=gen, device=dev)
    set_gates(model, XATTN_GATE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"phase vlm: {cfg.name} {cfg.n_layers} layers in {len(model.xattn)} groups {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters ({weights / 1e9:.2f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s, gates {XATTN_GATE}, memory allocated "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB [{card}]")
    dt = model.embed.dtype
    vision = torch.randn((fu["batch"], cfg.vision_tokens, cfg.d_model), generator=gen,
                         device=dev).to(dt)
    tokens, metrics, launches, first_s, prefill_s = prefill_runs(
        "phase vlm prefill", cfg, model, dev, fu, gen, extra=dict(vision=vision))
    b, s = tokens.shape
    say(f"phase vlm prefill: B={b} S={s} beside {tuple(vision.shape)} vision features, nll "
        f"{metrics['nll']:.4f} (ln V {np.log(cfg.vocab):.4f}); first run {first_s:.3f} s, second "
        f"{prefill_s:.3f} s ({b * s / prefill_s:.0f} tokens/s, host clock); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB beside {weights / 1e9:.2f} GB of "
        f"weights; launches {launches} [{card}]")
    prefill_profile("phase vlm prefill", cfg, model, tokens, note=f" [{card}]",
                    extra=dict(vision=vision))

    served = torch.randn((fu["slots"], cfg.vision_tokens, cfg.d_model), generator=gen,
                         device=dev).to(dt)
    nbytes, ops = cross_decode_bound(cfg, model, fu["slots"], fu["cache_len"],
                                     cfg.vision_tokens, len(model.xattn))
    profiled_decode("phase vlm decode", cfg, model, dev, fu, extra=dict(vision=served),
                    note=f"; bound {max(nbytes / HBM_BYTES_PER_S, ops / BF16_TC_FLOPS) * 1e3:.2f}"
                    f" ms [{card}]")
    serve_loop("phase vlm serve", cfg, model, fu, dict(vision=served), nbytes, ops, card)
    del served

    with torch.inference_mode():
        h = model.embed[tokens]
        h = h + lm._cross_block(cfg, model.xattn[0], h, vision, True)
    rec = layer0_attention_record("flash_attention[vlm prefill]", cfg, model, tokens,
                                  launches["flash_attention"], h=h)
    del model, h, vision
    torch.cuda.empty_cache()
    return rec


def phase_whisper(dev, card: str) -> None:
    """whisper-base whole: in float32 the decoder's prefill against the
    encoder's output with the kernel against without (one launch a decoder
    layer), and decode with ``memory = _run_encoder(frames)`` against the
    prefill; in bf16 a prefill at the decoder's own context (no launch, by
    the guard), a profiled decode window and launch.serve's loop."""
    import torch
    from repro_torch.models import lm

    ex, fu = WHISPER_EXACT, WHISPER_FULL
    cfg = arch_config(WHISPER_ARCH, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(7)
    model = lm.LM(cfg, generator=gen, device=dev)
    set_gates(model, XATTN_GATE)        # unread by the decoder (gated=False), as in the reference
    b, s = ex["batch"], ex["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    frames = torch.randn((b, cfg.encoder_frames, cfg.d_model), generator=gen, device=dev)
    got, err, launches = kernel_vs_plain("whisper exact", cfg, model,
                                         dict(tokens=tokens, frames=frames), cfg.n_layers)
    with torch.inference_mode():
        memory = lm._run_encoder(cfg, model, frames)
    derr = teacher_forced("whisper exact", cfg, model, dev, tokens, got, ex["decode"],
                          memory=memory)
    say(f"phase whisper exact: {cfg.name} {cfg.encoder_layers} + {cfg.n_layers} layers float32, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, decoder "
        f"{b} x {s} against {tuple(frames.shape)} frames: kernel vs plain max err {err:.2e}, "
        f"decode with the encoder's memory vs prefill over {ex['decode']} positions max err "
        f"{derr:.2e} ({LM_TOL}), flash_attention launches {launches} (the decoder's layers; "
        f"the encoder runs none, as in the reference)")
    del model, got, memory
    torch.cuda.empty_cache()

    cfg = arch_config(WHISPER_ARCH)
    model = lm.LM(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    dt = model.embed.dtype
    frames = torch.randn((fu["batch"], cfg.encoder_frames, cfg.d_model), generator=gen,
                         device=dev).to(dt)
    tokens, metrics, launches, first_s, prefill_s = prefill_runs(
        "phase whisper prefill", cfg, model, dev, fu, gen, flash=0, extra=dict(frames=frames))
    say(f"phase whisper prefill: {cfg.dtype}, B={fu['batch']} S={fu['seq']} beside "
        f"{tuple(frames.shape)} frames (encoder included), nll {metrics['nll']:.4f} (ln V "
        f"{np.log(cfg.vocab):.4f}); first run {first_s:.3f} s, second {prefill_s:.3f} s "
        f"({tokens.numel() / prefill_s:.0f} decoder tokens/s, host clock); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB beside {weights / 1e9:.3f} GB of "
        f"weights; flash_attention launches {launches['flash_attention']} ({fu['seq']} is not a "
        f"multiple of 128) [{card}]")
    prefill_profile("phase whisper prefill", cfg, model, tokens, note=f" [{card}]",
                    extra=dict(frames=frames))
    with torch.inference_mode():
        memory = lm._run_encoder(cfg, model, frames[:fu["slots"]])
    nbytes, ops = cross_decode_bound(cfg, model, fu["slots"], fu["cache_len"],
                                     cfg.encoder_frames, cfg.n_layers)
    profiled_decode("phase whisper decode", cfg, model, dev, fu, extra=dict(memory=memory),
                    note=f"; bound {max(nbytes / HBM_BYTES_PER_S, ops / BF16_TC_FLOPS) * 1e3:.3f}"
                    f" ms [{card}]")
    serve_loop("phase whisper serve", cfg, model, fu, dict(memory=memory), nbytes, ops, card)
    del model, memory, frames
    torch.cuda.empty_cache()


def phase_vlm_audio(dev, card: str):
    """The vlm and audio phases in order, each timed; together within
    VLM_AUDIO_SECONDS.  Returns flash_attention's vlm prefill record."""
    start = time.perf_counter()
    t0 = time.perf_counter()
    phase_vlm_exact(dev, arch_config(VLM_ARCH, n_layers=VLM_EXACT["n_layers"], dtype="float32"))
    say(f"phase vlm exact: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec = phase_vlm_full(dev, arch_config(VLM_ARCH), card)
    say(f"phase vlm: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_whisper(dev, card)
    say(f"phase whisper: {time.perf_counter() - t0:.1f} s")
    total = time.perf_counter() - start
    check(total <= VLM_AUDIO_SECONDS, f"the vlm and audio phases took {total:.1f} s, more than "
          f"{VLM_AUDIO_SECONDS:.0f} s")
    say(f"phases vlm exact, vlm, whisper: {total:.1f} s (limit {VLM_AUDIO_SECONDS:.0f} s)")
    return rec


def updated_params_match(got, want, opt_want, lr) -> tuple[float, float, int]:
    """Every parameter of ``got`` (a module, or whole tensors by name) within
    STEP_TOL of ``want``'s after one AdamW step, except the elements whose
    first moment says 0 < |g| < 1e-6 (Adam's step there moves steeply with
    g), held to 2 lr.  Returns the largest difference outside and inside
    that set, and its size."""
    import torch

    worst, worst_tiny, tiny_n = 0.0, 0.0, 0
    got = dict(got.named_parameters()) if hasattr(got, "named_parameters") else got
    with torch.no_grad():
        for (name, a), b in zip(got.items(), want.parameters()):
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


def sharded_checks(rank: int, world: int, dev, tmp: str) -> dict:
    """In each rank of phase sharded (see ``sharded_worker``): the sharded
    step against the unsharded one, then the elastic restore.  Returns
    rank 0's numbers."""
    import copy
    from dataclasses import replace

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.models.steps import make_train_step, shard_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, TrainLoop

    sh = SHARDED
    mesh = init_device_mesh(dev.type, (world, 1), mesh_dim_names=("data", "model"))
    cfg = lm_config(n_layers=sh["n_layers"], dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(3)
    base = lm.LM(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (sh["batch"] * world, sh["seq"]), generator=gen,
                           device=dev)
    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1))
    plain = copy.deepcopy(base)
    popt = adamw_init(plain)
    popt, pm = make_train_step(cfg, warmup_steps=1)(plain, popt, batch, 0)
    pm = {k: float(v) for k, v in pm.items()}
    model = shard_model(base, mesh)
    opt = adamw_init(model)
    step = make_train_step(cfg, warmup_steps=1, use_kernel=True, mesh=mesh)
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    opt, m = step(model, opt, batch, 0)
    m = {k: float(v) for k, v in m.items()}
    first_s = time.perf_counter() - t0
    launches = registry.launch_counts()
    full = {name: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
            for name, p in model.named_parameters()}
    placements = {name: str(tuple(p.placements)) for name, p in model.named_parameters()
                  if isinstance(p, DTensor)}
    out = dict(mesh=(world, 1), loss=m["loss"], grad_norm=m["grad_norm"], plain=pm,
               launches=launches, first_s=first_s, placements=sorted(set(placements.values())))
    if rank == 0:
        check(all(np.isfinite([m["loss"], m["grad_norm"]])) and all(
            np.isclose(m[k], pm[k], **LM_TOL) for k in ("loss", "grad_norm")),
            f"sharded: loss {m['loss']} / grad_norm {m['grad_norm']} on the mesh with the "
            f"kernels, {pm['loss']} / {pm['grad_norm']} unsharded without ({LM_TOL})")
        out["worst"], out["worst_tiny"], out["tiny"] = updated_params_match(
            full, plain, popt, m["lr"])
    layers, local = cfg.n_layers, sh["batch"]
    check(launches["flash_attention"] == 2 * layers and launches["flash_attention_bwd"] == layers,
          f"sharded: launches {launches}, expected flash_attention {2 * layers} (remat) and "
          f"its backward {layers} a step of a local batch of {local}")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    opt, m2 = step(model, opt, batch, 1)
    torch.cuda.synchronize(dev)
    out["step_s"] = time.perf_counter() - t0
    out["loss2"] = float(m2["loss"])
    del model, opt, plain, popt, base, full
    torch.cuda.empty_cache()

    # elastic restore: an unsharded run's checkpoint resumed on the mesh
    scfg = replace(get_smoke(LM_ARCH), dtype="float32")
    tc = TrainConfig(steps=sh["loop_steps"], batch=sh["loop_batch"], seq=sh["loop_seq"],
                     ckpt_dir=os.path.join(tmp, "full"), ckpt_every=1, base_lr=1e-3,
                     warmup_steps=1, log_every=1)
    cut_dir = os.path.join(tmp, "cut")
    if rank == 0:
        whole = TrainLoop(scfg, tc, device=dev).run()
        TrainLoop(scfg, replace(tc, ckpt_dir=cut_dir, steps=sh["loop_cut"]), device=dev).run()
    dist.barrier()
    resumed = TrainLoop(scfg, replace(tc, ckpt_dir=cut_dir), mesh=mesh).run()
    steps = [h["step"] for h in resumed["history"]]
    check(steps == list(range(sh["loop_cut"], sh["loop_steps"])),
          f"sharded: steps after the restore {steps}")
    got = {name: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
           for name, p in resumed["model"].named_parameters()}
    if rank == 0:
        worst = 0.0
        for name, want in whole["model"].named_parameters():
            ok = torch.allclose(got[name], want.detach(), **STEP_TOL)
            check(ok, f"sharded: {name} after the restore on the mesh differs from the "
                  "uninterrupted unsharded run")
            worst = max(worst, float((got[name] - want.detach()).abs().max()))
        out["restore_worst"] = worst
        out["restore_nll"] = resumed["history"][-1]["nll"]
    del resumed, got
    out.update(sharded_decode(rank, world, dev, cfg, mesh))
    torch.cuda.empty_cache()
    # the moe family through make_serve_step(mesh=) in two of its dispatch modes
    t0 = time.perf_counter()
    for mode in SHARDED_MOE_MODES:
        mcfg = moe_config(n_layers=sh["n_layers"], dtype="float32", moe_dispatch_sharding=mode)
        out[f"moe_{mode}"] = sharded_decode(rank, world, dev, mcfg, mesh)
        torch.cuda.empty_cache()
    out["moe_s"] = time.perf_counter() - t0
    return out


def sharded_decode(rank: int, world: int, dev, cfg, mesh) -> dict:
    """In each rank of phase sharded: ``cfg`` (float32) sharded over
    ``mesh`` decodes SHARDED["decode"] seeded tokens a row through
    ``make_serve_step(mesh=...)``, the state placed by
    ``init_decode_state(..., mesh=...)``; rank 0 decodes the same tokens
    unsharded from the same weights (each data rank's rows alone under the
    MoE's "manual" dispatch, which routes them alone) and checks argmax
    ids and logits (LM_TOL) each step."""
    import copy

    import torch

    from repro_torch.models import lm
    from repro_torch.models.steps import make_serve_step, shard_model

    sh = SHARDED
    gen = torch.Generator(device=dev).manual_seed(5)
    model = lm.LM(cfg, generator=gen, device=dev)
    plain = copy.deepcopy(model) if rank == 0 else None
    shard_model(model, mesh)
    b = sh["decode_batch"] * world
    tokens = torch.randint(0, cfg.vocab, (sh["decode"], b), generator=gen, device=dev)
    state = lm.init_decode_state(cfg, b, sh["decode_cache"], device=dev, mesh=mesh)
    step = make_serve_step(cfg, mesh=mesh)
    t0 = time.perf_counter()
    got = []
    for t in tokens:
        logits, state = step(model, state, dict(tokens=t))
        got.append(logits.full_tensor())
    torch.cuda.synchronize(dev)
    out = dict(decode_ms=(time.perf_counter() - t0) / sh["decode"] * 1e3,
               decode_placements=sorted({str(tuple(v.placements))
                                         for v in state["cache"].values()}))
    del model, state
    if rank == 0:
        parts = world if cfg.moe_dispatch_sharding == "manual" else 1
        n = b // parts
        pstep = make_serve_step(cfg)
        want = [[] for _ in tokens]
        for r in range(parts):
            pstate = lm.init_decode_state(cfg, n, sh["decode_cache"], device=dev)
            for i, t in enumerate(tokens):
                logits, pstate = pstep(plain, pstate, dict(tokens=t[r * n:(r + 1) * n]))
                want[i].append(logits)
        worst = 0.0
        for i, w in enumerate(want):
            w = torch.cat(w)
            check(torch.equal(got[i].argmax(-1), w.argmax(-1))
                  and torch.allclose(got[i], w, **LM_TOL),
                  f"sharded decode ({cfg.name}): step {i} ids or logits differ from the "
                  f"unsharded decode (max |diff| {float((got[i] - w).abs().max()):.2e}, "
                  f"{LM_TOL})")
            worst = max(worst, float((got[i] - w).abs().max()))
        out["decode_worst"] = worst
    return out


def sharded_worker(rank: int, world: int, init_file: str, tmp: str) -> None:
    """One rank of phase sharded: card ``rank``, an NCCL process group of
    ``world`` ranks through a file store; rank 0 writes its numbers to
    ``tmp``/result.json."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, device_id=dev)
    try:
        out = sharded_checks(rank, world, dev, tmp)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


class DryRun:
    """``launch.dryrun`` of each of SHARDED_DRYRUN, one after the other in
    a child process started with the script, so that the traces (host
    work, no card) run beside the kernel and LM phases; ``phase sharded``
    reads their JSON."""

    def __init__(self):
        import tempfile

        self._folder = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
        argvs = [["--arch", arch, "--shape", shape, "--out", self._folder.name]
                 + ["--multi-pod"] * multi_pod for arch, shape, multi_pod in SHARDED_DRYRUN]
        code = ("import sys\nfrom repro_torch.launch.dryrun import main\n"
                f"sys.exit(max(main(argv) for argv in {argvs!r}))")
        self._proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))

    def result(self) -> list[dict]:
        """Wait for the dry runs and return their cells' JSON, in
        SHARDED_DRYRUN's order."""
        _, err = self._proc.communicate(timeout=600)
        check(self._proc.returncode == 0, f"dry run exited {self._proc.returncode}: "
              f"{err[-2000:]}")
        out = []
        for arch, shape, multi_pod in SHARDED_DRYRUN:
            mesh_name = "2x16x16" if multi_pod else "16x16"
            with open(os.path.join(self._folder.name,
                                   f"{arch}__{shape}__{mesh_name}.json")) as f:
                out.append(json.load(f))
        return out

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.communicate()
        self._folder.cleanup()


def phase_sharded(card: str, dry: DryRun) -> None:
    """The sharded training step and decode on an NCCL mesh over every
    card, in spawned child processes (one a card); then the
    production-mesh dry runs' results, traced in another child since the
    script began; checks each, prints their numbers and the phase's time
    (the wait for the dry runs included) against SHARDED_SECONDS."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        mp.spawn(sharded_worker, args=(world, os.path.join(tmp, "pg"), tmp), nprocs=world,
                 join=True)
        with open(os.path.join(tmp, "result.json")) as f:
            r = json.load(f)
    cells = dry.result()
    seconds = time.perf_counter() - t0
    sh = SHARDED
    say(f"phase sharded: {LM_ARCH} {sh['n_layers']} layers float32 on a {tuple(r['mesh'])} "
        f"NCCL (data, model) mesh, FSDP2 placements {r['placements']}, batch "
        f"{sh['batch'] * r['mesh'][0]} x {sh['seq']}: loss {r['loss']:.6f} vs "
        f"{r['plain']['loss']:.6f} unsharded without the kernels, grad_norm "
        f"{r['grad_norm']:.6f} vs {r['plain']['grad_norm']:.6f} ({LM_TOL}); updated "
        f"parameters max |diff| {r['worst']:.2e} ({STEP_TOL}), {r['worst_tiny']:.2e} on the "
        f"{r['tiny']} elements with 0 < |g| < 1e-6; launches a step {r['launches']}; first "
        f"step {r['first_s']:.2f} s, second {r['step_s'] * 1e3:.1f} ms (loss {r['loss2']:.6f}) "
        f"[{card}]")
    say(f"phase sharded: the smoke config's unsharded TrainLoop checkpoint at step "
        f"{sh['loop_cut'] - 1} restored onto the mesh and stepped to {sh['loop_steps']}: "
        f"parameters within {STEP_TOL} of the uninterrupted run (max |diff| "
        f"{r['restore_worst']:.2e}), nll {r['restore_nll']:.4f}")
    whole = " (every placement whole on one card: the unsplit path only)" if world == 1 else ""
    say(f"phase sharded: {LM_ARCH} {sh['n_layers']} layers float32 decoding {sh['decode']} "
        f"steps of {sh['decode_batch'] * r['mesh'][0]} rows on the mesh through "
        f"make_serve_step(mesh=), cache placements {r['decode_placements']}{whole}: argmax ids "
        f"equal to the unsharded decode's, logits max |diff| {r['decode_worst']:.2e} "
        f"({LM_TOL}); {r['decode_ms']:.1f} ms a step")
    for mode in SHARDED_MOE_MODES:
        m = r[f"moe_{mode}"]
        alone = " (each data rank's rows alone)" if mode == "manual" else ""
        say(f"phase sharded: {MOE_ARCH} {sh['n_layers']} layers float32 \"{mode}\" decoding "
            f"{sh['decode']} steps of {sh['decode_batch'] * r['mesh'][0]} rows on the mesh "
            f"through make_serve_step(mesh=), cache placements {m['decode_placements']}{whole}: "
            f"argmax ids equal to the unsharded decode's{alone}, logits max |diff| "
            f"{m['decode_worst']:.2e} ({LM_TOL}); {m['decode_ms']:.1f} ms a step")
    say(f"phase sharded: the moe decode checks took {r['moe_s']:.1f} s")
    for (arch, shape, multi_pod), d in zip(SHARDED_DRYRUN, cells):
        check(d["status"] == "ok" and d["memory"]["temp_bytes"] > 0
              and d["collectives"]["total"] > 0,
              f"dry run {arch} x {shape}: {d.get('status')} {d.get('error')}")
        mem, roof, coll = d["memory"], d["roofline"], d["collectives"]
        say(f"phase sharded: dry run {arch} x {shape} x {d['mesh']} ({d['chips']} fake ranks, "
            f"traced in {d['seconds_trace']:.1f} s): per device parameters "
            f"{mem['param_bytes'] / 1e9:.3f} GB, gradients {mem['grad_bytes'] / 1e9:.3f}, "
            f"optimizer {mem['optimizer_bytes'] / 1e9:.3f}, cache "
            f"{mem['cache_bytes'] / 1e9:.3f}, step peak {mem['temp_bytes'] / 1e9:.3f}; FLOPs "
            f"{roof['hlo_flops_per_chip']:.4e} a device (model FLOPs share "
            f"{d['useful_flops_ratio']:.3f}), bytes {roof['hlo_bytes_per_chip']:.4e}; collective "
            f"bytes {json.dumps(coll['per_kind'])} counts {json.dumps(coll['counts'])}; terms "
            f"compute {roof['t_compute']:.4f} s, memory {roof['t_memory']:.4f} s, collective "
            f"{roof['t_collective']:.4f} s, dominant {roof['dominant']}")
    say(f"phase sharded: {seconds:.1f} s (limit {SHARDED_SECONDS:.0f} s)")
    check(seconds <= SHARDED_SECONDS, f"phase sharded took {seconds:.1f} s, over "
          f"{SHARDED_SECONDS} s")


def store_builder(conn, cfg: dict, folder: str) -> None:
    """In a child process: build the block store of ``cfg`` (PAGERANK's
    shape: R-MAT, descending degree order, blocks) on the host, save each
    field of ``interop.STORE_FIELDS`` into ``folder`` as ``.npy``, then send
    through ``conn`` the three steps' seconds and the graph's name and
    direction."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import build_block_store, degree_order, rmat
    from repro_torch.interop import STORE_FIELDS

    t0 = time.perf_counter()
    g = rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"])
    t1 = time.perf_counter()
    g, _ = degree_order(g, ascending=False)
    t2 = time.perf_counter()
    store = build_block_store(g, cfg["p"])
    t3 = time.perf_counter()
    for k in STORE_FIELDS:
        np.save(os.path.join(folder, f"{k}.npy"),
                store.layout.cuts if k == "cuts" else getattr(store, k))
    conn.send(dict(seconds=(t1 - t0, t2 - t1, t3 - t2), name=g.name, directed=g.directed))
    conn.close()


class StoreBuild:
    """The PageRank store built on the host in a child process (spawned,
    daemonic: it ends with this process) while this one drives the card.
    The build is numpy work of minutes on the card's machine; its arrays
    (≈ 5 GB at PAGERANK's scale, most of it ``row_block_ptr``) come back
    through files in a temporary folder, removed once read (a pipe took 88
    s for them on the H100's host)."""

    def __init__(self, cfg: dict):
        import multiprocessing
        import tempfile

        self._folder = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
        ctx = multiprocessing.get_context("spawn")
        self._conn, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=store_builder, args=(send, dict(cfg), self._folder.name),
                                 daemon=True)
        self._proc.start()
        send.close()

    def result(self):
        """Wait for the store: (store, the build's (rmat, degree order, block
        store) seconds in the child, seconds waited here, reading
        included)."""
        from repro_torch.interop import STORE_FIELDS, store_from_numpy

        t0 = time.perf_counter()
        try:
            head = self._conn.recv()
        except EOFError:
            self._proc.join()
            check(False, f"the store's build process ended with code {self._proc.exitcode}")
        self._proc.join()
        self._conn.close()
        with self._folder as folder:
            fields = {k: np.load(os.path.join(folder, f"{k}.npy"), mmap_mode="r")
                      for k in STORE_FIELDS}
            store = store_from_numpy(fields, directed=head["directed"], name=head["name"])
            del fields
        return store, head["seconds"], time.perf_counter() - t0


def run(dev, card: str, build: StoreBuild, dry: DryRun) -> list[dict]:
    """The phases in order; returns the per-kernel records.  ``card`` is
    the card's name and power limit, printed beside phase serve's numbers;
    ``build`` is the PageRank store's build and ``dry`` the production-mesh
    dry run, which run on the host beside the kernel and LM phases."""
    import torch

    start = time.perf_counter()

    def mark(what: str) -> None:
        say(f"[{time.perf_counter() - start:.1f} s into the phases] {what}")

    gen = torch.Generator(device=dev).manual_seed(0)
    phase_kernels(dev, gen)
    ell = phase_lm_kernels(dev, gen)
    t0 = time.perf_counter()
    bwd = phase_attn_bwd(dev, gen)
    say(f"phase kernels backward: {time.perf_counter() - t0:.1f} s")

    mark("the LM phases")
    phase_lm_exact(dev, lm_config(n_layers=LM_EXACT["n_layers"], dtype="float32"))
    attn = phase_lm_full(dev, lm_config())
    t0 = time.perf_counter()
    ex = MOE_EXACT
    phase_moe_exact(dev, moe_config(n_layers=ex["n_layers"], dtype="float32",
                                    capacity_factor=ex["capacity_factor"]))
    say(f"phase moe exact: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_attn = phase_moe_full(dev, moe_config(), card)
    say(f"phase moe: {time.perf_counter() - t0:.1f} s")
    phase_ssm(dev, card)
    vlm_attn = phase_vlm_audio(dev, card)
    t0 = time.perf_counter()
    phase_train_exact(dev, lm_config(n_layers=TRAIN_EXACT["n_layers"], dtype="float32"))
    say(f"phase train exact: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bwd_launches = phase_train(dev, lm_config(n_layers=TRAIN["n_layers"]), card)
    say(f"phase train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_loop(dev)
    say(f"phase train loop: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    phase_sharded(card, dry)
    bwd_rec = record("flash_attention_bwd", bwd_launches, bwd["err"], bwd["ms"], bwd["plain_ms"],
                     bwd["nbytes"], bwd["ops"], bwd["library_ms"], rate=BF16_TC_FLOPS)
    torch.cuda.empty_cache()

    mark("the graph phases")
    store, (rmat_s, order_s, blocks_s), waited = build.result()
    g = store.graph
    say(f"phase pagerank: graph + store {rmat_s + order_s + blocks_s:.1f} s (rmat {rmat_s:.1f}, "
        f"degree order {order_s:.1f}, block store {blocks_s:.1f}; host, in a child process "
        f"beside the kernel and LM phases; waited {waited:.1f} s for it, reading included), "
        f"n {g.n}, arcs {g.m}")
    plan, spmv, pr_res, pr_short, pr_three = phase_pagerank(dev, store)
    frontier, bfs_res = phase_bfs(dev, store, plan.schedule)
    schedule = plan.schedule
    del plan
    cc, cc_ms = phase_algorithms(dev, store)
    store._device_cache.clear()     # the streamed plans hold no in-core copy
    torch.cuda.empty_cache()
    mark("phase stream")
    streamed, rate, runs = phase_stream(dev, store, schedule, pr_res, pr_short, bfs_res, cc,
                                        cc_ms)
    mark("phase hetero")
    hetero_cc = phase_hetero(dev, store, runs, rate, bfs_res, cc, cc_ms, pr_res, pr_short)
    mark("phase resilience")
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
    mark("phase tc")
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
    mark("phase suite")
    phase_suite(dev, card)
    torch.cuda.empty_cache()
    mark("done")
    return [spmv, frontier, tc, attn, moe_attn, vlm_attn, bwd_rec, ell, *served]


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
    build = StoreBuild(PAGERANK)
    dry = DryRun()
    try:
        t0 = time.perf_counter()
        logs = _build.build_all(list(SOURCES))
        say(f"build: {len(SOURCES)} kernels in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
        tensor_core_report(logs)
        kernels = run(dev, card, build, dry)
    finally:
        dry.close()
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
