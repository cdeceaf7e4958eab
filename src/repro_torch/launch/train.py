"""End-to-end training driver, on one device or sharded over a mesh.

Fault tolerance comes from the TrainLoop substrate (atomic checkpoints +
auto-resume): re-running the same command after a crash continues from
the newest verified checkpoint, on the same mesh or another (elastic).
Runs on the current card; with none present it raises unless ``--device
cpu``.  The vlm and audio families are refused (``TrainLoop``'s pipeline
makes no vision or frames).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --smoke --steps 100 --batch 8 --seq 128 [--use-kernel] [--device cpu]

``--mesh data=D,model=M`` shards the model over D × M ranks, one process
a rank as ``torchrun`` starts them (NCCL on the cards, gloo with
``--device cpu``); rank 0 prints and writes the checkpoints:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite-3-8b --smoke --steps 20 --batch 8 --mesh data=2,model=2 --use-kernel
"""
from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from ..configs import get_config, get_smoke
from ..train import TrainConfig, TrainLoop
from .mesh import make_local_mesh


def _parse_mesh(text: str) -> dict:
    """``data=D,model=M`` → {"data": D, "model": M} (either may be left out)."""
    out = {}
    for part in text.split(","):
        k, v = part.split("=", 1)
        if k not in ("data", "model"):
            raise ValueError(f"--mesh takes data= and model=; got {k!r}")
        out[k] = int(v)
    return out


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
    ap.add_argument("--mesh", default=None, metavar="data=D,model=M",
                    help="shard over a (data, model) mesh of torchrun's ranks")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(
        steps=args.steps, batch=args.batch, seq=args.seq, base_lr=args.lr,
        microbatch=args.microbatch, ckpt_every=args.ckpt_every, use_kernel=args.use_kernel,
        **({} if args.ckpt_dir is None else dict(ckpt_dir=args.ckpt_dir)),
    )
    mesh = None
    if args.mesh:
        shape = _parse_mesh(args.mesh)
        mesh = make_local_mesh(shape.get("data"), shape.get("model", 1),
                               device=args.device or "cuda")
    loop = TrainLoop(cfg, tc, device=None if mesh else args.device, mesh=mesh)
    printer = loop.writer
    out = loop.run(on_step=lambda m: print(json.dumps(m)) if printer else None)
    first, last = out["history"][0], out["history"][-1]
    where = f"a {tuple(mesh.mesh.shape)} mesh of {mesh.device_type}" if mesh else loop.device
    if printer:
        print(f"done: {cfg.name} loss {first['nll']:.3f} -> {last['nll']:.3f} "
              f"({last['tokens_per_s']:.0f} tok/s on {where})")
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
