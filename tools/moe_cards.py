#!/usr/bin/env python3
"""``chip_smoke.py``'s ``phase moe exact`` and ``phase moe`` alone, on one card.

Builds only ``flash_attention`` (the one kernel of the MoE path) and
drives the two phase functions of ``chip_smoke.py`` at the same
configurations: deepseek-moe-16b at full width, 2 layers, float32, with a
capacity factor that drops no slot (kernel path against plain path,
decode against prefill, batched serving against solo, then the dropped
share at the config's own factor); then the whole model in bf16 (a 2 x
4096 prefill through ``make_prefill_step``, a profiled decode window,
``ServeEngine`` serving 8 requests).  Every check of ``chip_smoke.py``
holds here; any failure exits non-zero.  The last line is the
``flash_attention[moe prefill]`` record as JSON.  Run from the repository
root on a machine with a card::

    python tools/moe_cards.py
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
        print("moe_cards: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    cs.say(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all(["flash_attention"])
    cs.say(f"build: flash_attention in {time.perf_counter() - t0:.1f} s")

    ex = cs.MOE_EXACT
    t0 = time.perf_counter()
    cs.phase_moe_exact(dev, cs.moe_config(n_layers=ex["n_layers"], dtype="float32",
                                          capacity_factor=ex["capacity_factor"]))
    cs.say(f"phase moe exact: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec = cs.phase_moe_full(dev, cs.moe_config(), card)
    cs.say(f"phase moe: {time.perf_counter() - t0:.1f} s")
    cs.say(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
