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
``seed`` on the device (a different stream than ``jax.random``'s).
There is no jit or donation to port, and ``use_pallas`` becomes
``use_kernel``.

With ``mesh`` (a ``DeviceMesh`` over every rank, ``launch.mesh.
make_local_mesh``; ``torchrun`` starts one process a rank) the model is
drawn whole from the seed on every rank and sharded by
``models.steps.shard_model``: parameters FSDP over ``data`` and
tensor-parallel over ``model``, the batch split over ``data``.  Every
rank makes ``TokenPipeline(step)``'s global batch and trains on its
slice.  A checkpoint is gathered whole (every rank takes part) and
kept and written by rank 0 only, in the same layout, so a run resumes
on another mesh or on one device (elastic), and the reference's loop
resumes it.  A restore reads the stacked arrays one at a time and
places each on the mesh as it is read (``checkpoint.restore_checkpoint``
with ``shardings`` from ``interop.stacked_layout``), each rank keeping
its shards.
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
import torch.distributed as dist

from ..checkpoint import CheckpointManager, latest_step, save_checkpoint
from ..configs.base import ArchConfig
from ..core.engine import resolve_device
from ..data import TokenPipeline
from ..interop import load_lm_params, lm_params_to_numpy, opt_state_from_numpy, \
    opt_state_to_numpy, stacked_layout
from ..models.lm import LM
from ..models.steps import make_train_step, shard_model
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
    card; raises without one unless the CPU is named), or sharded over
    ``mesh`` (on the mesh's device type, this rank's current card)."""

    def __init__(self, cfg: ArchConfig, tc: TrainConfig, *, device=None, mesh=None):
        if cfg.family in ("vlm", "audio"):
            raise ValueError(
                f"TrainLoop's TokenPipeline makes tokens and labels only; {cfg.name}'s "
                f"{cfg.family} family needs vision or frames in every batch: train it "
                "through make_train_step")
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh
        if mesh is not None:
            device = "cpu" if mesh.device_type == "cpu" else torch.cuda.current_device()
        self.device = resolve_device(device)
        self.writer = mesh is None or dist.get_rank() == 0
        self.pipeline = TokenPipeline(tc.seed, tc.batch, tc.seq, cfg.vocab)
        self.ckpt = CheckpointManager(tc.ckpt_dir, every=tc.ckpt_every)
        self._step_fn = make_train_step(
            cfg, base_lr=tc.base_lr, total_steps=tc.steps, warmup_steps=tc.warmup_steps,
            microbatch=tc.microbatch, use_kernel=tc.use_kernel, mesh=mesh)

    def _state(self, model: LM, opt: dict) -> dict | None:
        """The checkpointed state in the reference's layout (host numpy)
        on the writer; on a mesh every rank takes part in the gathers and
        the others keep nothing (None)."""
        params = lm_params_to_numpy(self.cfg, model, keep=self.writer)
        opt = opt_state_to_numpy(self.cfg, opt, keep=self.writer)
        return dict(params=params, opt=opt) if self.writer else None

    def _layout(self, model: LM, opt: dict) -> tuple[dict, dict | None]:
        """The checkpointed state's tree with no data, as a restore takes
        it: each leaf's dtype, and on a mesh where each goes."""
        cfg = self.cfg
        template, shardings = ({k: {} for k in ("params", "opt")} for _ in range(2))
        template["params"], shardings["params"] = stacked_layout(cfg,
                                                                 dict(model.named_parameters()))
        for k, v in opt.items():
            template["opt"][k], shardings["opt"][k] = (
                stacked_layout(cfg, v) if isinstance(v, dict) else (v.dtype, None))
        return template, shardings if self.mesh is not None else None

    def _save(self, step: int, model: LM, opt: dict, *, final: bool = False) -> None:
        """A checkpoint at ``step`` (every ``ckpt_every`` steps, or
        ``final``), written by rank 0 of a mesh once every rank has
        gathered the state."""
        if not final and step % self.ckpt.every:
            return
        state = self._state(model, opt)
        if self.writer:
            if final:
                save_checkpoint(self.tc.ckpt_dir, step, state)
            else:
                self.ckpt.maybe_save(step, state)
        if self.mesh is not None:
            dist.barrier()

    def run(self, *, on_step=None) -> dict:
        """Train from the newest checkpoint (or from the seeded weights) to
        ``tc.steps``.  Returns the model, its parameters by name, the
        optimizer state and the logged history (one dict of floats per
        logged step, with ``step`` and ``tokens_per_s``)."""
        cfg, tc = self.cfg, self.tc
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        model = LM(cfg, generator=gen, device=self.device)
        if self.mesh is not None:
            shard_model(model, self.mesh)
        opt = adamw_init(model)
        start = 0
        if latest_step(tc.ckpt_dir) is not None:
            template, shardings = self._layout(model, opt)
            state, start = self.ckpt.restore_or_init(lambda: template, shardings=shardings)
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
            self._save(step, model, opt)
        # always leave a final checkpoint at the last step
        self._save(tc.steps - 1, model, opt, final=True)
        return dict(model=model, params=dict(model.named_parameters()), opt=opt,
                    history=history)
