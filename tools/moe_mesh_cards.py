#!/usr/bin/env python3
"""qwen3-moe-235b-a22b served at full width, sharded over four cards.

One process a card (``torch.multiprocessing.spawn``, an NCCL process
group through a file store), the model sharded by
``repro_torch.models.steps.shard_model`` on a ``("data", "model")`` mesh
(the expert stacks placed by ``expert_rules``: split on their hidden f
under ``"auto"``, as the reference's default rules say, on E under
``"manual"``'s EP-only rules) and served by ``make_prefill_step(mesh=...)``
and ``make_serve_step(mesh=...)``.  The weights are never whole on a card
nor on the host: the model is built on ``meta``, sharded, given storage by
``to_empty`` and filled by ``mesh_serve_cards.seeded_fill`` (each element
from its global index), so that one card and every mesh hold the same
weights.

1. exactness (EXACT: full width, 2 layers, 6.22 B parameters, 24.9 GB in
   float32 on one card; TF32 off): an EXACT["batch"] × EXACT["seq"]
   prefill's metrics, then EXACT["prompts"] seeded prompts of
   EXACT["prompt_len"] tokens fed token by token through the decode step
   and EXACT["new"] greedy tokens, on each of EXACT_CASES, against the
   unsharded model on rank 0's card (under ``"manual"``: each data rank's
   rows served alone on the one card, as the reference's ``_manual_moe``
   routes each data shard's tokens alone).  The MoE's routes are compared
   before values (every call's experts for every token; where they part,
   the one-card router's margin between the K-th and (K+1)-th
   probabilities is printed); greedy ids may part only where the one-card
   logits' top two lie within EXACT_TOL's atol (a tie), and the line says
   where;
2. the model at full width and FULL["n_layers"] of its 94 layers in bf16
   (120.66 B parameters, 60.3 GB a card) on FULL["mesh"]: the sharded
   prefill step at FULL["batch"] × FULL["seq"] with ``use_kernel=True``
   (``flash_attention`` on each rank's 16 query heads against its one K/V
   head, a launch a layer, counted), timed, and profiled on rank 0 (the
   card's busy time as the union of its kernels' intervals, the idle
   share, NCCL's share of busy and the expert products' (``aten::bmm``)
   share); ``flash_attention`` timed on layer 0's local q, k, v beside its
   plain version and SDPA, with its bound; then decode at FULL["batch"]
   against a FULL["seq"]-position cache, ms a step beside the bytes bound
   (a card's weights and cache read once: the capacity buffer runs every
   expert); each card's peak memory.

Every number is printed beside ``nvidia-smi``'s card name and power
limit; the last line is the results as JSON.  Run from the repository
root on a machine with four cards::

    python tools/moe_mesh_cards.py

``--device cpu`` rehearses the same flow on four gloo processes at a
small width (SMALL; the attention takes its plain versions, so no launch
is counted).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
from chip_smoke import MoeRoutes, bound  # noqa: E402
from mesh_serve_cards import compare, host_profile, kernel_times, seeded_fill  # noqa: E402
from sharded_cards import profile_step, say, sync  # noqa: E402

def stage(rank: int, what: str) -> None:
    """A progress line of this rank on stderr: seconds since its start, the
    card's allocated and reserved GB, ``what``."""
    import torch

    mem = ""
    if torch.cuda.is_initialized():
        mem = (f", {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
               f"{torch.cuda.memory_reserved() / 1e9:.2f} reserved")
    print(f"[rank {rank} +{time.perf_counter() - T0:.1f} s{mem}] {what}", file=sys.stderr,
          flush=True)


T0 = time.perf_counter()
ARCH = "qwen3-moe-235b-a22b"
WORLD = 4
SEED = 0
#: the exactness cases: (data, model) mesh and dispatch mode
EXACT_CASES = (((1, 4), "auto"), ((2, 2), "auto"), ((2, 2), "manual"))
EXACT = dict(n_layers=2, batch=2, seq=256, prompts=8, prompt_len=8, new=16, cache=32)
#: float32 against one card, as chip_smoke's LM_TOL (the partial sums' order differs)
EXACT_TOL = dict(atol=2e-4, rtol=1e-3)
#: the full-width run: 48 of the 94 layers (60.3 GB a card in bf16), prefill batch x
#: sequence (also the decode batch and cache), timed prefill steps, timed decode steps
FULL = dict(mesh=(1, 4), n_layers=48, batch=2, seq=4096, decode_batch=8, prefill_timed=2,
            decode_timed=8)
#: --device cpu: the same flow at a small width
SMALL = dict(d_model=128, n_heads=8, n_kv_heads=4, head_dim=64, d_ff=128, moe_d_ff=64,
             vocab=512, n_experts=8, top_k=2)
SMALL_EXACT = dict(EXACT, batch=2, seq=32)
SMALL_FULL = dict(FULL, n_layers=2, seq=128, decode_timed=2)
#: each part's wall limit (seconds): its processes are killed past it; a collective that
#: waits NCCL_TIMEOUT_S ends its process
PART_SECONDS = dict(full=330, exact=240)
NCCL_TIMEOUT_S = 150
#: the CPU op whose kernels are the expert products (the MoE's three bmm a layer)
BMM = ("aten::bmm",)


def config(small: bool, **changes):
    from dataclasses import replace

    from repro_torch.configs import get_config

    return replace(get_config(ARCH), **(dict(SMALL, **changes) if small else changes))


def build(cfg, dev, mesh=None):
    """The LM of ``cfg`` with SEED's weights: built on meta, sharded over
    ``mesh`` where one is given, storage on ``dev``, then filled."""
    from repro_torch.models import lm
    from repro_torch.models.steps import shard_model

    model = lm.LM(cfg, device="meta")
    if mesh is not None:
        shard_model(model, mesh)
    model.to_empty(device=dev)
    seeded_fill(model, SEED)
    return model


# ---------------------------------------------------------------- exactness


def greedy(cfg, model, dev, prompts, ex, mesh=None) -> tuple:
    """``prompts`` (B, prompt_len) fed token by token, then ex["new"]
    greedy tokens: (ids (new, B), the logits that chose them (new, B, V)
    float32 on the host, the MoE calls' routes)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.steps import make_serve_step

    step = make_serve_step(cfg, mesh=mesh)
    state = lm.init_decode_state(cfg, prompts.shape[0], ex["cache"], device=dev, mesh=mesh)

    def run(tokens):
        nonlocal state
        logits, state = step(model, state, dict(tokens=tokens))
        return logits.full_tensor() if mesh is not None else logits

    with MoeRoutes() as routes:
        for t in range(prompts.shape[1]):
            logits = run(prompts[:, t])
        ids, seen = [], []
        for _ in range(ex["new"]):
            tok = logits.argmax(-1)
            ids.append(tok.cpu())
            seen.append(logits.float().cpu())
            logits = run(tok)
    return torch.stack(ids), torch.stack(seen), routes


def prefill_metrics(cfg, model, batch, mesh=None) -> tuple:
    """The prefill step's metrics (floats) of ``batch`` and its routes."""
    from repro_torch.models.steps import make_prefill_step

    with MoeRoutes() as routes:
        m = make_prefill_step(cfg, mesh=mesh)(model, batch)
    return {k: float(v) for k, v in m.items()}, routes


def one_card(cfg, model, dev, batch, prompts, parts: int, ex) -> dict:
    """The unsharded model on each of ``parts`` consecutive slices of the
    batch and of the prompts alone: the prefill metrics averaged over them,
    the greedy run's ids and logits concatenated on the batch, and each
    MoE call's routes and margins concatenated on the tokens."""
    import torch

    runs = []
    for r in range(parts):
        rows, prows = (slice(r * len(t) // parts, (r + 1) * len(t) // parts)
                       for t in (batch["tokens"], prompts))
        pm, pr = prefill_metrics(cfg, model, {k: v[rows] for k, v in batch.items()})
        ids, seen, dr = greedy(cfg, model, dev, prompts[prows], ex)
        runs.append((pm, pr, ids, seen, dr))
    cat = lambda lists: [torch.cat(c).cpu() for c in zip(*lists)]  # noqa: E731
    return dict(metrics={k: sum(p[0][k] for p in runs) / parts for k in runs[0][0]},
                prefill_idx=cat([p[1].idx for p in runs]),
                prefill_margin=cat([p[1].margin for p in runs]),
                ids=torch.cat([p[2] for p in runs], 1), seen=torch.cat([p[3] for p in runs], 1),
                decode_idx=cat([p[4].idx for p in runs]),
                decode_margin=cat([p[4].margin for p in runs]))


def routes_part(got: list, want: list, margins: list, calls: int | None = None) -> dict:
    """The mesh's routes (each MoE call's (T, K) experts, its tokens in the
    batch's order) against one card's, over the first ``calls`` calls: the
    tokens routed otherwise and, at the first, the one-card margin."""
    calls = len(want) if calls is None else calls
    out = dict(calls=calls, differ=0)
    if len(got) < calls:
        out["missing"] = calls - len(got)
        return out
    for c in range(calls):
        bad = (got[c] != want[c]).any(-1).nonzero()[:, 0]
        if len(bad):
            out["differ"] += len(bad)
            out.setdefault("first", dict(call=c, token=int(bad[0]),
                                         margin=float(margins[c][bad[0]])))
    return out


def exact(dev, rank, small: bool, tmp: str) -> list:
    """Each of EXACT_CASES: the unsharded model on rank 0's card (the other
    ranks wait for its file in ``tmp``, not in a collective), then the
    mesh; rank 0 compares."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    ex = SMALL_EXACT if small else EXACT
    gen = torch.Generator(device="cpu").manual_seed(1)
    base = config(small, dtype="float32", n_layers=ex["n_layers"])
    tokens = torch.randint(0, base.vocab, (ex["batch"], ex["seq"]), generator=gen).to(dev)
    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1))
    prompts = torch.randint(0, base.vocab, (ex["prompts"], ex["prompt_len"]),
                            generator=gen).to(dev)
    one = {}
    if rank == 0:
        model = build(base, dev)
        # "manual" routes each data rank's rows alone: served alone on one card
        for shape, mode in EXACT_CASES:
            parts = shape[0] if mode == "manual" else 1
            if parts not in one:
                one[parts] = one_card(base, model, dev, batch, prompts, parts, ex)
                stage(rank, f"one card, {parts} part(s) served")
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        Path(tmp, "one_card_done").touch()
    while not Path(tmp, "one_card_done").exists():
        time.sleep(0.5)
    dist.barrier()
    results = []
    for shape, mode in EXACT_CASES:
        cfg = config(small, dtype="float32", n_layers=ex["n_layers"], moe_dispatch_sharding=mode)
        mesh = init_device_mesh(dev.type, shape, mesh_dim_names=("data", "model"))
        model = build(cfg, dev, mesh)
        moe = model.layers[0].moe
        placements = {k: [str(p) for p in getattr(moe, k).placements]
                      for k in ("router", "w_gate", "w_down")}
        local_experts = moe.w_gate.to_local().shape
        stage(rank, f"exact {shape} {mode}: built")
        metrics, proutes = prefill_metrics(cfg, model, batch, mesh)
        stage(rank, f"exact {shape} {mode}: prefilled")
        ids, seen, droutes = greedy(cfg, model, dev, prompts, ex, mesh)
        stage(rank, f"exact {shape} {mode}: decoded")
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # each data rank's routes, model rank 0's, in the batch's order
        mine = (mesh.get_local_rank("data"), mesh.get_local_rank("model"),
                [t.cpu() for t in proutes.idx], [t.cpu() for t in droutes.idx])
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        if rank:
            continue
        heads = sorted((r for r in every if r[1] == 0), key=lambda r: r[0])
        p_idx = [torch.cat(c) for c in zip(*(r[2] for r in heads))]
        d_idx = [torch.cat(c) for c in zip(*(r[3] for r in heads))]
        want = one[shape[0] if mode == "manual" else 1]
        out = dict(mesh=shape, mode=mode, placements=placements,
                   local_w_gate=list(local_experts), metrics=metrics,
                   one_metrics=want["metrics"])
        out["metrics_within"] = all(
            abs(metrics[k] - v) <= EXACT_TOL["atol"] + EXACT_TOL["rtol"] * abs(v)
            for k, v in want["metrics"].items())
        out["prefill_routes"] = routes_part(p_idx, want["prefill_idx"], want["prefill_margin"])
        out.update(compare(ids, seen, want["ids"], want["seen"], EXACT_TOL, ex["new"]))
        # the decode calls up to the first generated step whose ids part (a layer a call)
        steps = ex["prompt_len"] + min(out["steps_equal"] + 1, ex["new"])
        out["decode_routes"] = routes_part(d_idx, want["decode_idx"], want["decode_margin"],
                                           steps * ex["n_layers"])
        out["routes_equal"] = all(r["differ"] == 0 and "missing" not in r
                                  for r in (out["prefill_routes"], out["decode_routes"]))
        out["ids"] = ids[:, 0].tolist()
        results.append(out)
    return results


# ---------------------------------------------------------------- the whole model


def full(dev, rank, small: bool) -> dict:
    """The model at FULL["n_layers"] on FULL["mesh"]: prefill, the kernel on
    layer 0's inputs, decode; rank 0's numbers and every rank's peak."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import registry
    from repro_torch.models import attention, lm
    from repro_torch.models.steps import make_prefill_step, make_serve_step

    run = SMALL_FULL if small else FULL
    cuda = dev.type == "cuda"
    cfg = config(small, n_layers=run["n_layers"])
    mesh = init_device_mesh(dev.type, run["mesh"], mesh_dim_names=("data", "model"))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build(cfg, dev, mesh)
    sync(dev)
    stage(rank, "full: built")
    moe = model.layers[0].moe
    out = dict(mesh=run["mesh"], n_layers=cfg.n_layers, build_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()),
               weights_gb_a_card=sum((p.to_local() if hasattr(p, "to_local") else p).numel()
                                     * p.element_size() for p in model.parameters()) / 1e9,
               local_heads=model.layers[0].attn.wq.to_local().shape[1] // cfg.d_head,
               local_kv_heads=model.layers[0].attn.wk.to_local().shape[1] // cfg.d_head,
               w_gate_local=list(moe.w_gate.to_local().shape),
               w_gate_placements=[str(p) for p in moe.w_gate.placements])
    gen = torch.Generator(device="cpu").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (run["batch"], run["seq"]), generator=gen).to(dev)
    batch = dict(tokens=tokens, labels=tokens.roll(-1, dims=1))
    prefill = make_prefill_step(cfg, mesh=mesh, use_kernel=True)

    captured = {}
    kernel = attention.flash_attention

    def first_call(q, k, v, **kw):
        captured.setdefault("qkv", (q.clone(), k.clone(), v.clone()))
        return kernel(q, k, v, **kw)

    attention.flash_attention = first_call
    try:
        registry.reset_launch_counts()
        m = prefill(model, batch)
        out["launches"] = registry.launch_counts()
    finally:
        attention.flash_attention = kernel
    out["loss"] = float(m["loss"])
    out["load_balance"] = float(m["load_balance"])
    stage(rank, "full: first prefill")
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(run["prefill_timed"]):
        prefill(model, batch)
    sync(dev)
    out["prefill_s"] = (time.perf_counter() - t0) / run["prefill_timed"]
    out["prefill_tokens_per_s"] = run["batch"] * run["seq"] / out["prefill_s"]
    stage(rank, "full: prefill timed")
    if cuda and rank == 0:
        _, wall, busy, nccl, top, ops = profile_step(lambda: prefill(model, batch), BMM)
        out["prefill_profile"] = dict(wall_ms=wall, busy_ms=busy, nccl_ms=nccl,
                                      bmm_ms=ops.get(BMM[0]), top=top)
        out["kernel"] = kernel_times(*captured["qkv"])
    else:
        prefill(model, batch)
    captured.clear()
    stage(rank, "full: prefill profiled")
    if cuda:
        torch.cuda.empty_cache()

    b = run["decode_batch"]
    step = make_serve_step(cfg, mesh=mesh)
    state = lm.init_decode_state(cfg, b, run["seq"], device=dev, mesh=mesh)
    local = state["cache"]["k"].to_local()
    out["cache_gb_a_card"] = 2 * local.numel() * local.element_size() / 1e9
    out["cache_placements"] = [str(p) for p in state["cache"]["k"].placements]
    n = run["decode_timed"] + 4
    state["pos"].fill_(run["seq"] - n)       # the last steps of a full cache
    tok = torch.randint(0, cfg.vocab, (b,), generator=gen).to(dev)
    for _ in range(2):
        logits, state = step(model, state, dict(tokens=tok))
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(run["decode_timed"]):
        logits, state = step(model, state, dict(tokens=tok))
    sync(dev)
    out["decode_ms"] = (time.perf_counter() - t0) / run["decode_timed"] * 1e3
    out["decode_tokens_per_s"] = b / out["decode_ms"] * 1e3
    stage(rank, "full: decode timed")
    if cuda and rank == 0:
        _, wall, busy, nccl, top, ops = profile_step(
            lambda: step(model, state, dict(tokens=tok)), BMM)
        out["decode_profile"] = dict(wall_ms=wall, busy_ms=busy, nccl_ms=nccl,
                                     bmm_ms=ops.get(BMM[0]), top=top)
        out["decode_host"] = host_profile(lambda: step(model, state, dict(tokens=tok)), dev)
    else:
        step(model, state, dict(tokens=tok))
        step(model, state, dict(tokens=tok))
    full_logits = logits.full_tensor()
    out["logits_finite"] = bool(torch.isfinite(full_logits).all())
    out["logits_shape"] = list(full_logits.shape)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    out["peak_gb"] = [p / 1e9 for p in peaks]
    # the bytes a decode step must read on a card: its weights and its cache
    out["decode_bound_ms"] = bound(out["weights_gb_a_card"] * 1e9
                                   + out["cache_gb_a_card"] * 1e9, 0)[0]
    return out


def worker(rank: int, world: int, init_file: str, tmp: str, small: bool, part: str) -> None:
    """One rank of ``part`` ("exact" or "full"); rank 0 writes its result
    to ``tmp``/<part>.json.  An exception is printed and ends the process
    at once (a rank that left a collective would hang in the process
    group's teardown)."""
    import datetime
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    if small:
        dev, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(2)
    else:
        dev, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=NCCL_TIMEOUT_S),
                            **({} if small else dict(device_id=dev)))
    try:
        t0 = time.perf_counter()
        res = exact(dev, rank, small, tmp) if part == "exact" else full(dev, rank, small)
        if rank == 0:
            with open(os.path.join(tmp, f"{part}.json"), "w") as f:
                json.dump(dict(results=res, seconds=time.perf_counter() - t0), f)
    except BaseException:
        print(f"[rank {rank}] {part} failed:\n{traceback.format_exc()}", file=sys.stderr,
              flush=True)
        os._exit(1)
    dist.destroy_process_group()


def run_part(part: str, tmp: str, small: bool) -> dict | None:
    """``part`` on WORLD spawned ranks, killed past PART_SECONDS[part]:
    its result, or None (the reason printed)."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(worker, args=(WORLD, os.path.join(tmp, f"pg_{part}"), tmp, small, part),
                   nprocs=WORLD, join=False)
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=2):
            if time.perf_counter() - t0 > PART_SECONDS[part] * (4 if small else 1):
                for proc in ctx.processes:
                    proc.kill()
                say(f"{part}: killed after {time.perf_counter() - t0:.0f} s")
                return None
    except Exception as e:  # a rank failed: its traceback is above
        say(f"{part}: {type(e).__name__}: {str(e)[:300]}")
        return None
    with open(os.path.join(tmp, f"{part}.json")) as f:
        return json.load(f)


def report(res: dict, card: str, small: bool) -> list:
    """Print every reading; return the failed checks."""
    failed = [part for part in ("exact", "full") if res.get(part) is None]
    ex_run = SMALL_EXACT if small else EXACT
    for ex in (res["exact"] or {}).get("results", []):
        tie = (f"; ids part at generated step {ex['steps_equal']} where one card's top two "
               f"logits lie {ex['margin']:.3e} apart (a tie within {EXACT_TOL['atol']}: "
               f"{ex['near_tie']})" if ex["steps_equal"] < ex_run["new"] else "")
        routes = []
        for what in ("prefill_routes", "decode_routes"):
            r = ex[what]
            first = (f", first at call {r['first']['call']} token {r['first']['token']} where "
                     f"one card's K-th and (K+1)-th router probabilities lie "
                     f"{r['first']['margin']:.3e} apart" if "first" in r else "")
            routes.append(f"{what.split('_')[0]} {r['differ']} tokens routed otherwise over "
                          f"{r['calls']} calls{first}")
        say(f"exact: {ARCH} {ex_run['n_layers']} layers float32 on {tuple(ex['mesh'])} "
            f"\"{ex['mode']}\" (router {ex['placements']['router']}, w_gate "
            f"{ex['placements']['w_gate']} local {ex['local_w_gate']}): {'; '.join(routes)}; "
            f"prefill {ex_run['batch']} x {ex_run['seq']} metrics {ex['metrics']} vs one card "
            f"{ex['one_metrics']} (within {EXACT_TOL}: {ex['metrics_within']}); greedy ids "
            f"equal for {ex['steps_equal']} of {ex_run['new']} generated steps{tie}; logits max "
            f"|diff| {ex['max_abs']:.3e} (within: {ex['within']}); first prompt's ids "
            f"{ex['ids']} [{card}]")
        if not (ex["ok"] and ex["metrics_within"]):
            failed.append(f"exact {tuple(ex['mesh'])} {ex['mode']}")
        if not ex["routes_equal"]:
            first = [ex[w].get("first") for w in ("prefill_routes", "decode_routes")]
            if any(f is None or f["margin"] > EXACT_TOL["atol"] for f in first if f) or any(
                    "missing" in ex[w] for w in ("prefill_routes", "decode_routes")):
                failed.append(f"routes {tuple(ex['mesh'])} {ex['mode']}")
    if res["exact"]:
        say(f"exact cases: {res['exact']['seconds']:.1f} s")
    if not res["full"]:
        return failed
    f = res["full"]["results"]
    run = SMALL_FULL if small else FULL
    say(f"{ARCH} at full width, {f['n_layers']} layers ({f['params'] / 1e9:.2f} B parameters, "
        f"bf16, {f['weights_gb_a_card']:.2f} GB a card) on {tuple(f['mesh'])}: "
        f"{f['local_heads']} query heads and {f['local_kv_heads']} K/V heads a rank, w_gate "
        f"{f['w_gate_placements']} local {f['w_gate_local']}, built in {f['build_s']:.1f} s; "
        f"prefill {run['batch']} x {run['seq']} {f['prefill_s'] * 1e3:.1f} ms a step, "
        f"{f['prefill_tokens_per_s']:.0f} tokens/s, loss {f['loss']:.4f}, load_balance "
        f"{f['load_balance']:.4f}; launches a prefill step {f['launches']} [{card}]")
    for what in ("prefill_profile", "decode_profile"):
        prof = f.get(what)
        if prof and prof["busy_ms"] is not None:
            busy = max(prof["busy_ms"], 1e-9)
            say(f"  {what.split('_')[0]} profiled on rank 0: {prof['wall_ms']:.1f} ms wall, the "
                f"card busy {prof['busy_ms']:.1f} ms (idle share "
                f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}), NCCL {prof['nccl_ms']:.1f} ms "
                f"(share of busy {prof['nccl_ms'] / busy:.3f}), expert products (aten::bmm) "
                f"{prof['bmm_ms']:.1f} ms (share of busy {prof['bmm_ms'] / busy:.3f}); busiest "
                f"(summed) {prof['top']}")
        elif prof:
            say(f"  {what.split('_')[0]} profiled on rank 0: {prof['wall_ms']:.1f} ms wall, "
                f"device time not measured ({prof['top']})")
    if "decode_host" in f:
        say(f"  decode step under cProfile on rank 0 (cumulative ms): {f['decode_host']}")
    if "kernel" in f:
        k = f["kernel"]
        say(f"  flash_attention[moe tp prefill] on layer 0's local q {k['shape']} {k['dtype']} "
            f"against one K/V head, causal: {k['kernel_ms']:.4f} ms ({k['tflops']:.1f} TFLOP/s), "
            f"plain {k['plain_ms']:.2f} ms, SDPA {k['sdpa_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}); max |err| against the plain version "
            f"{k['max_abs_err']:.2e}")
    say(f"  decode at batch {run['decode_batch']} against a {run['seq']}-position cache "
        f"({f['cache_gb_a_card']:.3f} GB a card, placements {f['cache_placements']}): "
        f"{f['decode_ms']:.2f} ms a step, {f['decode_tokens_per_s']:.1f} tokens/s, against "
        f"{f['decode_bound_ms']:.2f} ms to read a card's weights and cache once; logits "
        f"{f['logits_shape']} finite {f['logits_finite']}; peak memory per card "
        f"{[round(x, 2) for x in f['peak_gb']]} GB")
    want = 0 if small else f["n_layers"]        # a launch a layer on each rank
    if f["launches"].get("flash_attention", 0) != want:
        failed.append(f"prefill launches {f['launches']}, expected flash_attention {want}")
    if not f["logits_finite"]:
        failed.append("decode logits not finite")
    if not small and max(f["peak_gb"]) > 75:
        failed.append(f"a card's peak {max(f['peak_gb']):.2f} GB passes 75 GB")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    small = args.device == "cpu"
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if small:
        card = "cpu rehearsal (gloo), not a card"
    else:
        if torch.cuda.device_count() < WORLD:
            print(f"moe_mesh_cards: needs {WORLD} CUDA devices", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
    say(card)
    t_start = time.perf_counter()
    # an NCCL collective past its timeout ends the process soon, not after the heartbeat's
    # default eight minutes; the allocator grows segments rather than fragmenting 60 GB
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    os.environ.setdefault("TORCH_NCCL_HEARTBEAT_TIMEOUT_SEC", "60")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with tempfile.TemporaryDirectory(prefix="moe_mesh_cards_") as tmp:
        if not small:
            from repro_torch.kernels import _build

            t0 = time.perf_counter()
            _build.build_all(["flash_attention"])
            say(f"build: flash_attention in {time.perf_counter() - t0:.1f} s")
        res = {part: run_part(part, tmp, small) for part in ("full", "exact")}
    failed = report(res, card, small)
    say(f"moe_mesh_cards: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps(dict(card=card, results=res)))
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
