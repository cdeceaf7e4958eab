"""End-to-end LM training on the PyTorch port's substrates:
synthetic pipeline -> dense model -> AdamW -> atomic checkpoints.

Default: a ~20M-param qwen2.5-family model for 200 steps.  `--full-100m`
scales to ~100M params.  Checkpoints go under `--ckpt-dir` (default: a
directory in the temporary directory); rerunning continues from the last
one.  Runs on the current CUDA device unless `--device cpu`.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--full-100m] \
        [--device cpu]
"""
import argparse
import os
import tempfile
from dataclasses import replace

from repro_torch.configs import get_smoke
from repro_torch.core import resolve_device
from repro_torch.train import TrainConfig, TrainLoop

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--full-100m", action="store_true")
ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
ap.add_argument("--device", default=None, help="default: the current CUDA device")
args = ap.parse_args()

cfg = get_smoke("qwen2.5-32b")
if args.full_100m:
    cfg = replace(cfg, name="qwen-100m", n_layers=8, d_model=512, n_heads=8,
                  n_kv_heads=2, d_ff=2048, vocab=32000)
else:
    cfg = replace(cfg, name="qwen-20m", n_layers=4, d_model=256, n_heads=8,
                  n_kv_heads=2, d_ff=1024, vocab=8192)

tc = TrainConfig(steps=args.steps, batch=8, seq=256, base_lr=1e-3,
                 warmup_steps=20, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                 log_every=10)
loop = TrainLoop(cfg, tc, device=resolve_device(args.device))
out = loop.run(on_step=lambda m: print(
    f"step {m['step']:4d}  nll {m['nll']:.4f}  gnorm {m['grad_norm']:.2f} "
    f"{m['tokens_per_s']:.0f} tok/s"))
h = out["history"]
print(f"\n{cfg.name}: nll {h[0]['nll']:.3f} -> {h[-1]['nll']:.3f} over "
      f"{args.steps} steps  (resume-safe: rerun to continue from ckpt)")
