"""Learning-rate schedules as ``step → lr`` functions.

Port of ``repro/optim/schedules.py``.  The step is a Python int (or a
0-d integer tensor) and the rate a Python float: the train step reads
it on the host, as the reference's jitted step computes it beside the
update.
"""
from __future__ import annotations

import math

__all__ = ["linear_warmup", "cosine_schedule"]


def linear_warmup(base_lr: float, warmup_steps: int):
    def fn(step) -> float:
        return base_lr * min(1.0, (int(step) + 1) / max(warmup_steps, 1))
    return fn


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step) -> float:
        step = int(step)
        warm = min(1.0, (step + 1) / max(warmup_steps, 1))
        prog = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * prog))
        return base_lr * warm * cos
    return fn
