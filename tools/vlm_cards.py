#!/usr/bin/env python3
"""``chip_smoke.py``'s ``phase vlm exact``, ``phase vlm`` and ``phase whisper``
alone, on one card.

Builds only ``flash_attention`` and its backward (the kernels of these
paths) and drives the three phase functions of ``chip_smoke.py`` at the
same configurations: llama-3.2-vision-11b at full width, one group of 5
layers, float32 (kernel path against plain path, decode with the vision
features against prefill, one train step with the kernels against one
without); the whole model in bf16 (a 2 x 4096 prefill beside 2 x 1601
vision features through ``make_prefill_step``, a profiled decode window,
``launch.serve``'s loop); whisper-base whole in float32 and bf16.  Every
check of ``chip_smoke.py`` holds here; any failure exits non-zero.  The
last line is the ``flash_attention[vlm prefill]`` record as JSON.  Run
from the repository root on a machine with a card::

    python tools/vlm_cards.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("vlm_cards: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    cs.say(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    cs.say(f"build: flash_attention and its backward in {time.perf_counter() - t0:.1f} s")
    rec = cs.phase_vlm_audio(dev, card)
    cs.say(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
