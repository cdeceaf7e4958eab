#!/usr/bin/env python3
"""qwen1.5-32b served whole, sharded over four cards.

One process a card (``torch.multiprocessing.spawn``, an NCCL process
group through a file store), the model sharded by
``repro_torch.models.steps.shard_model`` on a ``("data", "model")`` mesh
and served by ``make_prefill_step(mesh=...)`` and ``make_serve_step(mesh=
...)`` against a decode state placed by ``init_decode_state(...,
mesh=...)``.  The weights are never whole on a card nor on the host: the
model is built on ``meta``, sharded, given storage by ``to_empty`` and
each parameter's shard filled from a counter-based hash of (SEED, the
parameter's name, each element's global index) (``seeded_fill``), so that
the unsharded model on one card and every mesh hold the same weights.

1. exactness at cut depth (EXACT: 8 layers), in bf16 and in float32 (TF32
   off; the sharp check, where no rounding of the tensor-parallel partial
   sums hides a fault): PROMPTS prompts of PROMPT_LEN seeded tokens fed
   token by token through the decode step, then NEW greedy tokens, on
   ``(1, 4)`` with the prompts as one batch (the cache split over its K/V
   heads) and on ``(4, 1)`` with the first prompt alone (batch 1: the
   cache's positions split over the data ranks); against the unsharded
   model on rank 0's card: a sample of the weights bit-equal, the greedy
   ids equal and the generated steps' logits within EXACT_TOL.  Ids may
   part only where the one-card logits' top two lie closer than the
   tolerance (a tie within the arithmetic's rounding), and the line says
   so; the logits are compared up to there;
2. the whole model (64 layers, 32.5 B parameters, bf16) on ``(1, 4)``:
   the sharded prefill step at FULL["batch"] × FULL["seq"] (the
   hand-written ``flash_attention`` on each rank's 10 local heads, a
   launch a layer, counted), timed and profiled on rank 0 (the card's busy
   time as the union of its kernels' intervals, the idle share, the NCCL
   kernels' time); ``flash_attention`` timed on layer 0's local q, k, v
   beside its plain version and SDPA, with its bound; then decode steps
   against a FULL["batch"] × FULL["seq"] cache (10.7 GB a card), timed
   and profiled the same way; each card's peak memory.

Every number is printed beside ``nvidia-smi``'s card name and power
limit; the last line is the results as JSON.  Run from the repository
root on a machine with four cards::

    python tools/mesh_serve_cards.py

``--device cpu`` rehearses the same flow on four gloo processes at a
small width (SMALL; the attention takes its plain versions, so no launch
is counted; the limits are printed and held).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
from chip_smoke import BF16_TC_FLOPS, bound, cuda_ms  # noqa: E402
from sharded_cards import profile_step, say, sync  # noqa: E402

ARCH = "qwen1.5-32b"
WORLD = 4
SEED = 0
#: the exactness cases: (data, model) mesh, prompts in the batch
EXACT_MESHES = (((1, 4), 4), ((4, 1), 1))
EXACT = dict(n_layers=8)
PROMPT_LEN, NEW, CACHE = 16, 32, 64
#: logits of the generated steps against one card: float32 as chip_smoke's LM_TOL; bf16
#: eight bf16 spacings at |logit| 4 (the tensor-parallel partial sums are rounded to bf16
#: before their all-reduce, one card rounds the whole sum once)
EXACT_TOL = {"float32": dict(atol=2e-4, rtol=1e-3), "bfloat16": dict(atol=0.125, rtol=0.0)}
#: the whole model's run on (1, 4): prefill batch x sequence (also the decode cache),
#: timed prefill steps, decode steps timed after two warm-up steps
FULL = dict(mesh=(1, 4), batch=8, seq=4096, prefill_timed=2, decode_timed=16)
#: parameters whose first SAMPLE_ROWS rows are compared between one card and a mesh
SAMPLE = ("embed", "lm_head", "final_norm", "layers.0.ln1", "layers.0.attn.wq",
          "layers.0.attn.bq", "layers.0.attn.wo", "layers.-1.mlp.w_down")
SAMPLE_ROWS = 256
#: --device cpu: the same flow at a small width
SMALL = dict(d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, n_layers=4)
SMALL_EXACT = dict(n_layers=2)
SMALL_FULL = dict(FULL, batch=8, seq=128, decode_timed=4)


def config(small: bool, **changes):
    from dataclasses import replace

    from repro_torch.configs import get_config

    return replace(get_config(ARCH), **(dict(SMALL, **changes) if small else changes))


# ---------------------------------------------------------------- weights


#: splitmix64's constants as signed 64-bit integers (torch's int64 wraps)
_GOLDEN = 0x9E3779B97F4A7C15 - 2**64
_M1, _M2 = 0xBF58476D1CE4E5B9 - 2**64, 0x94D049BB133111EB - 2**64


def _shr(x, n: int):
    """Logical right shift of an int64 tensor."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _uniform(key: int, index):
    """A float32 in [-1, 1) for each int64 ``index``: splitmix64 of
    (index · golden + key), its top 24 bits."""
    x = index * _GOLDEN + key
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    x = x ^ _shr(x, 31)
    return _shr(x, 40).float() * 2.0 ** -23 - 1.0


def _init_scale(name: str, shape) -> float | None:
    """How the LM initialises a dense-family parameter: None for a norm
    scale (ones) and 0.0 for a bias (zeros), else the scale of its draw
    (``dense_init``'s: 0.02 for the embedding, fan_in^-½ otherwise)."""
    leaf = name.split(".")[-1]
    if leaf in ("ln1", "ln2", "final_norm"):
        return None
    if leaf in ("bq", "bk", "bv"):
        return 0.0
    return 0.02 if leaf == "embed" else shape[0] ** -0.5


def seeded_fill(model, seed: int, rows: int = 4096, chunk: int = 1 << 25) -> None:
    """Fill every parameter of ``model`` (a dense- or moe-family LM with
    storage; plain tensors or DTensor shards) in place: element i of
    parameter ``name`` gets √3 · scale · u(seed, name, i), u uniform in
    [-1, 1), so its value depends on the global index alone and each rank
    fills its shard without the whole; norm scales 1, biases 0.  At most
    ``rows`` rows of dim 0, and about ``chunk`` elements, at a time."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import local_extent

    if model.cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"seeded_fill: {model.cfg.name} is neither a dense- nor a "
                                  "moe-family model")
    with torch.no_grad():
        for name, p in model.named_parameters():
            local = p.to_local() if isinstance(p, DTensor) else p
            start = (local_extent(p.shape, p.device_mesh, p.placements)[1]
                     if isinstance(p, DTensor) else (0,) * p.ndim)
            scale = _init_scale(name, p.shape)
            if scale is None or scale == 0.0:
                local.fill_(1.0 if scale is None else 0.0)
                continue
            key = (seed << 32) + zlib.crc32(name.encode())
            strides = [1] * p.ndim
            for d in range(p.ndim - 2, -1, -1):
                strides[d] = strides[d + 1] * p.shape[d + 1]
            dev = local.device
            inner = torch.zeros((), dtype=torch.int64, device=dev)
            for d in range(1, p.ndim):
                ax = (start[d] + torch.arange(local.shape[d], device=dev)) * strides[d]
                inner = inner[..., None] + ax
            step = max(1, min(rows, chunk // max(1, inner.numel())))
            for a in range(0, local.shape[0], step):
                n = min(step, local.shape[0] - a)
                first = (start[0] + a + torch.arange(n, device=dev)) * strides[0]
                index = first.reshape(n, *([1] * (p.ndim - 1))) + inner
                local[a:a + n].copy_(_uniform(key, index) * (3.0 ** 0.5 * scale))


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


def sample_params(model, n_layers: int) -> dict:
    """SAMPLE's first SAMPLE_ROWS rows, gathered whole (every rank of a mesh
    must call this), on the host."""
    from torch.distributed.tensor import DTensor

    params = dict(model.named_parameters())
    out = {}
    for name in SAMPLE:
        key = name.replace("layers.-1.", f"layers.{n_layers - 1}.")
        p = params[key].detach()
        out[key] = (p.full_tensor() if isinstance(p, DTensor) else p)[:SAMPLE_ROWS].cpu()
    return out


# ---------------------------------------------------------------- exactness


def greedy(cfg, model, dev, prompts, mesh=None) -> tuple:
    """``prompts`` (B, PROMPT_LEN) fed token by token, then NEW greedy
    tokens: (ids (NEW, B), the logits that chose them (NEW, B, V) float32
    on the host)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.steps import make_serve_step

    step = make_serve_step(cfg, mesh=mesh)
    state = lm.init_decode_state(cfg, prompts.shape[0], CACHE, device=dev, mesh=mesh)

    def run(tokens):
        nonlocal state
        logits, state = step(model, state, dict(tokens=tokens))
        return logits.full_tensor() if mesh is not None else logits

    for t in range(prompts.shape[1]):
        logits = run(prompts[:, t])
    ids, seen = [], []
    for _ in range(NEW):
        tok = logits.argmax(-1)
        ids.append(tok.cpu())
        seen.append(logits.float().cpu())
        logits = run(tok)
    return torch.stack(ids), torch.stack(seen)


def compare(ids, seen, want_ids, want_seen, tol, new: int = NEW) -> dict:
    """The mesh's greedy run against one card's: the first generated step
    whose ids part (NEW if none) and the one-card logits' top-two margin
    there; the logits' largest gap up to it, and whether that is within
    ``tol``; ``new`` generated steps."""
    import torch

    differ = (ids != want_ids).any(1).nonzero()
    first = int(differ[0]) if len(differ) else new
    out = dict(steps_equal=first)
    if first < new:
        top2 = want_seen[first].topk(2, -1).values
        out["margin"] = float((top2[:, 0] - top2[:, 1]).min())
        out["near_tie"] = out["margin"] <= tol["atol"]
    n = first + 1 if first < new else new
    gap = (seen[:n] - want_seen[:n]).abs()
    out["max_abs"] = float(gap.max())
    out["within"] = bool((gap <= tol["atol"] + tol["rtol"] * want_seen[:n].abs()).all())
    out["ok"] = out["within"] and (first == new or out["near_tie"])
    return out


def exact(dev, rank, world, small: bool) -> list:
    """Each dtype × EXACT_MESHES: the unsharded model greedy on rank 0's
    card, then the mesh; rank 0 compares."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    results = []
    for dtype in ("float32", "bfloat16"):
        cfg = config(small, dtype=dtype, **(SMALL_EXACT if small else EXACT))
        gen = torch.Generator(device="cpu").manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (max(b for _, b in EXACT_MESHES), PROMPT_LEN),
                                generator=gen).to(dev)
        one = {}
        if rank == 0:
            model = build(cfg, dev)
            one["sample"] = sample_params(model, cfg.n_layers)
            for _, b in EXACT_MESHES:
                one[b] = greedy(cfg, model, dev, prompts[:b])
            del model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
        for shape, b in EXACT_MESHES:
            mesh = init_device_mesh(dev.type, shape, mesh_dim_names=("data", "model"))
            model = build(cfg, dev, mesh)
            sample = sample_params(model, cfg.n_layers)
            ids, seen = greedy(cfg, model, dev, prompts[:b], mesh)
            placements = [str(p) for p in model.layers[0].attn.wq.placements]
            del model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            if rank:
                continue
            out = dict(dtype=dtype, mesh=shape, batch=b, wq_placements=placements,
                       weights_equal=all(torch.equal(sample[k], one["sample"][k])
                                         for k in sample))
            out.update(compare(ids, seen, *one[b], EXACT_TOL[dtype]))
            out["ids"] = ids[:, 0].tolist()
            results.append(out)
    return results


# ---------------------------------------------------------------- the whole model


def kernel_times(q, k, v) -> dict:
    """``flash_attention`` (causal) on layer 0's local q, k, v: its device
    time, its plain version's and SDPA's (CUDA events), its error against
    the plain version, and its bound (``chip_smoke.bound``: the larger of
    the bytes it must move over 3.35 TB/s and its products' FLOPs over 989
    TFLOP/s bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    bsz, h, s, d = q.shape
    flops = 4.0 * d * bsz * h * s * (s + 1) // 2          # two products over visible pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    out = dict(shape=list(q.shape), dtype=str(q.dtype),
               kernel_ms=cuda_ms(lambda: flash_attention_cuda(q, k, v), 5),
               sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True), 5),
               plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v), 2))
    out["max_abs_err"] = float((flash_attention_cuda(q, k, v).float()
                                - ref.attention_ref(q, k, v).float()).abs().max())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, BF16_TC_FLOPS)
    out["tflops"] = flops / out["kernel_ms"] / 1e9
    return out


#: where a decode step's host time goes: cumulative seconds of these functions
HOST_SPANS = ("unshard", "reshard", "decode_attention", "_mlp_block", "rms_norm", "_embed",
              "tp_in", "tp_out", "all_reduce", "all_gather", "__torch_dispatch__")


def host_profile(run, dev) -> dict:
    """``run()`` under cProfile (the host's Python): its wall ms and the
    cumulative ms of each of HOST_SPANS (the largest entry of that name)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run()
    sync(dev)
    prof.disable()
    out = dict(wall_ms=(time.perf_counter() - t0) * 1e3)
    for (_, _, name), row in pstats.Stats(prof).stats.items():
        if name in HOST_SPANS:
            out[name] = max(out.get(name, 0.0), row[3] * 1e3)
    return out


def full(dev, rank, small: bool) -> dict:
    """The whole model on FULL["mesh"]: prefill, the kernel on layer 0's
    inputs, decode; rank 0's numbers and every rank's peak memory."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import registry
    from repro_torch.models import attention, lm
    from repro_torch.models.steps import make_prefill_step, make_serve_step

    run = SMALL_FULL if small else FULL
    cuda = dev.type == "cuda"
    cfg = config(small)
    mesh = init_device_mesh(dev.type, run["mesh"], mesh_dim_names=("data", "model"))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build(cfg, dev, mesh)
    sync(dev)
    out = dict(mesh=run["mesh"], build_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()),
               local_heads=model.layers[0].attn.wq.to_local().shape[1] // cfg.d_head)
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
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(run["prefill_timed"]):
        prefill(model, batch)
    sync(dev)
    out["prefill_s"] = (time.perf_counter() - t0) / run["prefill_timed"]
    out["prefill_tokens_per_s"] = run["batch"] * run["seq"] / out["prefill_s"]
    if cuda and rank == 0:
        _, wall, busy, nccl, top = profile_step(lambda: prefill(model, batch))
        out["prefill_profile"] = dict(wall_ms=wall, busy_ms=busy, nccl_ms=nccl, top=top)
    else:
        prefill(model, batch)
    if cuda and rank == 0:
        out["kernel"] = kernel_times(*captured["qkv"])
    captured.clear()
    if cuda:
        torch.cuda.empty_cache()

    step = make_serve_step(cfg, mesh=mesh)
    state = lm.init_decode_state(cfg, run["batch"], run["seq"], device=dev, mesh=mesh)
    local = state["cache"]["k"].to_local()
    out["cache_gb_a_card"] = 2 * local.numel() * local.element_size() / 1e9
    out["cache_placements"] = [str(p) for p in state["cache"]["k"].placements]
    n = run["decode_timed"] + 4
    state["pos"].fill_(run["seq"] - n)       # the last steps of a full cache
    tok = torch.randint(0, cfg.vocab, (run["batch"],), generator=gen).to(dev)
    for _ in range(2):
        logits, state = step(model, state, dict(tokens=tok))
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(run["decode_timed"]):
        logits, state = step(model, state, dict(tokens=tok))
    sync(dev)
    out["decode_ms"] = (time.perf_counter() - t0) / run["decode_timed"] * 1e3
    out["decode_tokens_per_s"] = run["batch"] / out["decode_ms"] * 1e3
    if cuda and rank == 0:
        _, wall, busy, nccl, top = profile_step(
            lambda: step(model, state, dict(tokens=tok)))
        out["decode_profile"] = dict(wall_ms=wall, busy_ms=busy, nccl_ms=nccl, top=top)
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
    weights = sum((p.to_local() if hasattr(p, "to_local") else p).numel()
                  * p.element_size() for p in model.parameters())
    out["decode_bound_ms"] = bound(weights + out["cache_gb_a_card"] * 1e9, 0)[0]
    return out


def worker(rank: int, world: int, init_file: str, tmp: str, small: bool) -> None:
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
                            rank=rank, **({} if small else dict(device_id=dev)))
    try:
        results = dict(exact=exact(dev, rank, world, small), full=full(dev, rank, small))
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def report(res: dict, card: str, small: bool) -> list:
    """Print every reading; return the failed checks."""
    failed = []
    for ex in res["exact"]:
        tol = EXACT_TOL[ex["dtype"]]
        tie = (f"; ids part at generated step {ex['steps_equal']} where one card's top two "
               f"logits lie {ex['margin']:.3e} apart (a tie within {tol['atol']}: "
               f"{ex['near_tie']})" if ex["steps_equal"] < NEW else "")
        say(f"exact: {ARCH} {(SMALL_EXACT if small else EXACT)['n_layers']} layers "
            f"{ex['dtype']} on {tuple(ex['mesh'])} (wq {ex['wq_placements']}), batch "
            f"{ex['batch']}: weight sample bit-equal to one card's {ex['weights_equal']}; "
            f"greedy ids equal for {ex['steps_equal']} of {NEW} generated steps{tie}; logits "
            f"max |diff| {ex['max_abs']:.3e} ({tol}: {ex['within']}); first prompt's ids "
            f"{ex['ids']} [{card}]")
        if not (ex["ok"] and ex["weights_equal"]):
            failed.append(f"exact {ex['dtype']} {tuple(ex['mesh'])}")
    f = res["full"]
    run = SMALL_FULL if small else FULL
    say(f"{ARCH} whole ({'small' if small else '64 layers'}, {f['params'] / 1e9:.3f} B "
        f"parameters, bf16) on {tuple(f['mesh'])}, {f['local_heads']} local heads a "
        f"rank, built in {f['build_s']:.1f} s: prefill {run['batch']} x {run['seq']} "
        f"{f['prefill_s'] * 1e3:.1f} ms a step, {f['prefill_tokens_per_s']:.0f} tokens/s, "
        f"loss {f['loss']:.4f}; launches a prefill step {f['launches']} [{card}]")
    for what in ("prefill_profile", "decode_profile"):
        prof = f.get(what)
        if prof and prof["busy_ms"] is not None:
            say(f"  {what.split('_')[0]} profiled on rank 0: {prof['wall_ms']:.1f} ms wall, the "
                f"card busy {prof['busy_ms']:.1f} ms (idle share "
                f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}), NCCL {prof['nccl_ms']:.1f} ms "
                f"(share of busy {prof['nccl_ms'] / max(prof['busy_ms'], 1e-9):.3f}); busiest "
                f"(summed) {prof['top']}")
        elif prof:
            say(f"  {what.split('_')[0]} profiled on rank 0: {prof['wall_ms']:.1f} ms wall, "
                f"device time not measured ({prof['top']})")
    if "decode_host" in f:
        say(f"  decode step under cProfile on rank 0 (cumulative ms): {f['decode_host']}")
    if "kernel" in f:
        k = f["kernel"]
        say(f"  flash_attention[tp prefill] on layer 0's local q {k['shape']} {k['dtype']}, "
            f"causal: {k['kernel_ms']:.4f} ms ({k['tflops']:.1f} TFLOP/s), plain "
            f"{k['plain_ms']:.2f} ms, SDPA {k['sdpa_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}); max |err| against the plain version {k['max_abs_err']:.2e}")
    say(f"  decode against a {run['batch']} x {run['seq']} cache ({f['cache_gb_a_card']:.2f} GB "
        f"a card, placements {f['cache_placements']}): {f['decode_ms']:.2f} ms a step, "
        f"{f['decode_tokens_per_s']:.1f} tokens/s, against {f['decode_bound_ms']:.2f} ms to "
        f"read a card's weights and cache once; logits {f['logits_shape']} finite "
        f"{f['logits_finite']}; peak memory per card {[round(x, 2) for x in f['peak_gb']]} GB")
    want = 0 if small else config(small).n_layers       # a launch a layer on each rank
    if f["launches"].get("flash_attention", 0) != want:
        failed.append(f"prefill launches {f['launches']}, expected flash_attention {want}")
    if not f["logits_finite"]:
        failed.append("decode logits not finite")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    small = args.device == "cpu"
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.multiprocessing as mp

    if small:
        card = "cpu rehearsal (gloo), not a card"
    else:
        if torch.cuda.device_count() < WORLD:
            print(f"mesh_serve_cards: needs {WORLD} CUDA devices", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
    say(card)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_serve_cards_") as tmp:
        if not small:
            from repro_torch.kernels import _build

            t0 = time.perf_counter()
            _build.build_all(["flash_attention"])
            say(f"build: flash_attention in {time.perf_counter() - t0:.1f} s")
        mp.spawn(worker, args=(WORLD, os.path.join(tmp, "pg"), tmp, small), nprocs=WORLD,
                 join=True)
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
    failed = report(res, card, small)
    say(f"mesh_serve_cards: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps(dict(card=card, results=res)))
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
