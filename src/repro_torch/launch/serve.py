"""Batched serving driver: prefill-free cached decode of N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        [--smoke] [--batch 4] [--tokens 32] [--device cpu]

Weights are drawn on the device from a generator seeded 0.  Runs on the
current card; with none present it raises unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke
from ..core.engine import resolve_device
from ..models import lm
from ..models.steps import make_serve_step


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
    serve = make_serve_step(cfg)
    with torch.inference_mode():
        state = lm.init_decode_state(cfg, args.batch, args.cache_len, device=dev)
        toks = torch.zeros(args.batch, dtype=torch.int32, device=dev)
        out_tokens = []
        t0 = time.perf_counter()
        for _ in range(args.tokens):
            logits, state = serve(model, state, dict(tokens=toks))
            if args.temperature > 0:
                probs = torch.softmax(logits / args.temperature, dim=-1)
                toks = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                toks = torch.argmax(logits, dim=-1)
            toks = toks.to(torch.int32)
            out_tokens.append(toks)
        seq = torch.stack(out_tokens, 1).cpu()       # waits for the device
        dt = time.perf_counter() - t0
    print("generated token ids (first row):", seq[0][:16].tolist(), "...")
    print(f"{args.batch} streams × {args.tokens} tokens in {dt:.2f}s "
          f"→ {args.batch * args.tokens / dt:.1f} tok/s on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
