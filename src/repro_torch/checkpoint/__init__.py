"""Fault-tolerant checkpointing: atomic writes, an integrity-checked
latest pointer, auto-resume, and run-level snapshots
(:mod:`repro_torch.checkpoint.runstate`) that make ``Plan.resume`` /
``StreamingPlan.resume`` bit-identical for integer/bool attributes.
The on-disk format is the reference package's."""
from .ckpt import save_checkpoint, restore_checkpoint, latest_step, CheckpointManager
from .runstate import (
    RunSnapshot, save_runstate, load_runstate, latest_runstate_step,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager", "RunSnapshot", "save_runstate",
           "load_runstate", "latest_runstate_step"]
