#!/usr/bin/env python3
"""``chip_smoke.py``'s hybrid and ssm phases alone, on one card.

Drives ``phase hybrid exact``, ``phase xlstm exact``, ``phase hybrid`` and
``phase xlstm`` of ``chip_smoke.py`` at the same configurations:
hymba-1.5b and xlstm-1.3b at full width, depth cut, float32 (the Mamba
scan against its associative scan, decode past the ring cache's wrap,
the chunkwise mLSTM against the scan, decode layer by layer, batched
serving against solo), then each model whole in bf16 (2 x 4096 prefills
through ``make_prefill_step`` under both impls, a profiled decode window,
``ServeEngine`` serving 8 requests).  These paths launch no hand-written
kernel (a sliding window fails the attention kernel's guard; xLSTM has no
attention), so nothing is built.  Every check of ``chip_smoke.py`` holds
here; any failure exits non-zero.  Run from the repository root on a
machine with a card::

    python tools/ssm_cards.py
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ssm_cards: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    cs.say(card)
    cs.say(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    cs.phase_ssm(torch.device("cuda", 0), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
