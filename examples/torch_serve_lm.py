"""Batched serving on the PyTorch port: cached single-token decode loop
over a smoke-sized config with seeded random weights.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen2.5-32b] \
        [--tokens 24] [--device cpu]

The arch must be of the dense family (the others raise until their
ROADMAP item lands).  Runs on the current CUDA device unless `--device cpu`.
"""
import argparse

from repro_torch.launch.serve import main

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen2.5-32b")
ap.add_argument("--tokens", type=int, default=24)
ap.add_argument("--device", default=None, help="default: the current CUDA device")
args = ap.parse_args()
argv = ["--arch", args.arch, "--smoke", "--batch", "4", "--tokens", str(args.tokens)]
if args.device is not None:
    argv += ["--device", args.device]
raise SystemExit(main(argv))
