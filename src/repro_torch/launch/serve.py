"""Batched serving driver: prefill-free cached decode of N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        [--smoke] [--batch 4] [--tokens 32] [--device cpu]

Weights are drawn on the device from a generator seeded 0.  The vlm
family is served beside zero ``vision`` features (B, vision_tokens, d)
and the audio family beside a zero encoder ``memory`` (B,
encoder_frames, d), both in the param dtype, as the reference's ``launch.serve``
stubs them.  Runs on the current card; with none present it raises
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke
from ..core.engine import resolve_device
from ..configs.base import ArchConfig
from ..models import lm
from ..models.common import Dtype
from ..models.steps import make_serve_step


def stub_inputs(cfg: ArchConfig, batch: int, device) -> dict:
    """The zero ``vision`` (vlm) or ``memory`` (audio) that every step's
    batch carries beside the tokens; empty for the other families."""
    dt = Dtype(cfg.dtype).param
    if cfg.family == "vlm":
        return dict(vision=torch.zeros(batch, cfg.vision_tokens, cfg.d_model, dtype=dt,
                                       device=device))
    if cfg.is_encdec:
        return dict(memory=torch.zeros(batch, cfg.encoder_frames, cfg.d_model, dtype=dt,
                                       device=device))
    return {}


@torch.inference_mode()
def generate(cfg: ArchConfig, model: lm.LM, *, batch: int, tokens: int, cache_len: int,
             extra: dict, temperature: float = 0.0, generator=None):
    """``tokens`` cached decode steps of ``batch`` streams from token 0
    through ``make_serve_step``, each step's batch holding ``extra``
    beside the tokens; greedy, or sampled at ``temperature`` from
    ``generator``.  Returns the generated ids (B, tokens) on the host and
    the seconds taken (host clock, the device drained)."""
    dev = model.device
    serve = make_serve_step(cfg)
    state = lm.init_decode_state(cfg, batch, cache_len, device=dev)
    toks = torch.zeros(batch, dtype=torch.int32, device=dev)
    out_tokens = []
    t0 = time.perf_counter()
    for _ in range(tokens):
        logits, state = serve(model, state, dict(tokens=toks, **extra))
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            toks = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            toks = torch.argmax(logits, dim=-1)
        toks = toks.to(torch.int32)
        out_tokens.append(toks)
    seq = torch.stack(out_tokens, 1).cpu()       # waits for the device
    return seq, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm.LM(cfg, generator=gen, device=dev)
    seq, dt = generate(cfg, model, batch=args.batch, tokens=args.tokens,
                       cache_len=args.cache_len, extra=stub_inputs(cfg, args.batch, dev),
                       temperature=args.temperature, generator=gen)
    print("generated token ids (first row):", seq[0][:16].tolist(), "...")
    print(f"{args.batch} streams × {args.tokens} tokens in {dt:.2f}s "
          f"→ {args.batch * args.tokens / dt:.1f} tok/s on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
