"""End-to-end training driver on one device.

Fault tolerance comes from the TrainLoop substrate (atomic checkpoints +
auto-resume): re-running the same command after a crash continues from
the newest verified checkpoint.  Runs on the current card; with none
present it raises unless ``--device cpu``.  The vlm and audio families
are refused (``TrainLoop``'s pipeline makes no vision or frames).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --smoke --steps 100 --batch 8 --seq 128 [--use-kernel] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

from ..configs import get_config, get_smoke
from ..train import TrainConfig, TrainLoop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt under the temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--use-kernel", action="store_true",
                    help="attention through the hand-written flash_attention and its backward")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(
        steps=args.steps, batch=args.batch, seq=args.seq, base_lr=args.lr,
        microbatch=args.microbatch, ckpt_every=args.ckpt_every, use_kernel=args.use_kernel,
        **({} if args.ckpt_dir is None else dict(ckpt_dir=args.ckpt_dir)),
    )
    loop = TrainLoop(cfg, tc, device=args.device)
    out = loop.run(on_step=lambda m: print(json.dumps(m)))
    first, last = out["history"][0], out["history"][-1]
    print(
        f"done: {cfg.name} loss {first['nll']:.3f} -> {last['nll']:.3f} "
        f"({last['tokens_per_s']:.0f} tok/s on {loop.device})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
