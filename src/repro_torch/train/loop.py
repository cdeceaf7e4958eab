"""Fault-tolerant training loop.

Port of ``repro/train/loop.py``.  Composes the substrates: the data
pipeline (a pure function of the step, so replay-safe), the train step
(loss → grad → AdamW, optional microbatch accumulation), and the
checkpoint manager (atomic, auto-resume).  ``run()`` always begins with a
restore-or-initialize, so killing the process at any point loses at most
``ckpt_every`` steps, and always leaves a checkpoint of the last step.

Checkpoints are written in the reference's layout (``params`` as its
stacked parameter tree, ``opt`` as ``mu``, ``nu``, ``count``; see
:mod:`repro_torch.interop`), so either package's loop resumes the
other's.  The weights are drawn from a ``torch.Generator`` seeded with
``seed`` on the device (a different stream than ``jax.random``'s).  The
reference's mesh sharding waits for ROADMAP A13b's second half; there is
no jit or donation to port, and ``use_pallas`` becomes ``use_kernel``.
The loop refuses the vlm and audio families, as the reference's cannot
feed them: ``TokenPipeline`` makes tokens and labels only, and their
batches need ``vision`` or ``frames`` too (``make_train_step`` takes such
batches).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..checkpoint import CheckpointManager, latest_step, save_checkpoint
from ..configs.base import ArchConfig
from ..core.engine import resolve_device
from ..data import TokenPipeline
from ..interop import load_lm_params, lm_params_to_numpy, opt_state_from_numpy, \
    opt_state_to_numpy
from ..models.lm import LM
from ..models.steps import make_train_step
from ..optim import adamw_init

__all__ = ["TrainLoop", "TrainConfig"]


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainConfig:
    steps: int = 200
    batch: int = 8
    seq: int = 128
    base_lr: float = 3e-4
    warmup_steps: int = 20
    microbatch: int = 0
    seed: int = 0
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    log_every: int = 10
    use_kernel: bool = False


class TrainLoop:
    """Trains ``cfg`` as ``tc`` says on ``device`` (default: the current
    card; raises without one unless the CPU is named)."""

    def __init__(self, cfg: ArchConfig, tc: TrainConfig, *, device=None):
        if cfg.family in ("vlm", "audio"):
            raise ValueError(
                f"TrainLoop's TokenPipeline makes tokens and labels only; {cfg.name}'s "
                f"{cfg.family} family needs vision or frames in every batch: train it "
                "through make_train_step")
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.pipeline = TokenPipeline(tc.seed, tc.batch, tc.seq, cfg.vocab)
        self.ckpt = CheckpointManager(tc.ckpt_dir, every=tc.ckpt_every)
        self._step_fn = make_train_step(
            cfg, base_lr=tc.base_lr, total_steps=tc.steps, warmup_steps=tc.warmup_steps,
            microbatch=tc.microbatch, use_kernel=tc.use_kernel)

    def _state(self, model: LM, opt: dict) -> dict:
        """The checkpointed state in the reference's layout (host numpy)."""
        return dict(params=lm_params_to_numpy(self.cfg, model),
                    opt=opt_state_to_numpy(self.cfg, opt))

    def run(self, *, on_step=None) -> dict:
        """Train from the newest checkpoint (or from the seeded weights) to
        ``tc.steps``.  Returns the model, its parameters by name, the
        optimizer state and the logged history (one dict of floats per
        logged step, with ``step`` and ``tokens_per_s``)."""
        cfg, tc = self.cfg, self.tc
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        model = LM(cfg, generator=gen, device=self.device)
        opt = adamw_init(model)
        start = 0
        if latest_step(tc.ckpt_dir) is not None:
            state, start = self.ckpt.restore_or_init(lambda: self._state(model, opt))
            load_lm_params(cfg, model, state["params"])
            opt = opt_state_from_numpy(cfg, state["opt"], model)
        history = []
        t0 = time.perf_counter()
        tokens_done = 0
        for step in range(start, tc.steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline(step).items()}
            opt, metrics = self._step_fn(model, opt, batch, step)
            tokens_done += tc.batch * tc.seq
            if step % tc.log_every == 0 or step == tc.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}   # waits for the device
                dt = time.perf_counter() - t0
                m.update(step=step, tokens_per_s=tokens_done / max(dt, 1e-9))
                history.append(m)
                if on_step:
                    on_step(m)
            if step % self.ckpt.every == 0:
                self.ckpt.maybe_save(step, self._state(model, opt))
        # always leave a final checkpoint at the last step
        save_checkpoint(tc.ckpt_dir, tc.steps - 1, self._state(model, opt))
        return dict(model=model, params=dict(model.named_parameters()), opt=opt,
                    history=history)
