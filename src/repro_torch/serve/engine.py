"""Slot-based batched LM serving engine (token streams).

Port of ``repro/serve/engine.py``.  A fixed decode batch of B slots
serves a request queue in *waves*: a wave admits up to B requests,
step-decodes them together through one ``decode_step`` (prompt tokens
are teacher-forced through the same cached path, then generation
continues greedily), retires finished slots by masking, and starts the
next wave when the batch drains.  Every slot of a wave shares one cache
position, so the scalar-position decode step serves the whole stream.

The engine runs on ``device`` (by default the current card; raises
without one unless ``device="cpu"``), which must be where the model's
weights lie.  It refuses the vlm and audio families: its requests carry
tokens only, and their decode steps need ``vision`` features or the
encoder's ``memory`` as well (the reference's engine calls
``decode_step`` without them).  Serve those through ``make_serve_step``,
as ``repro_torch.launch.serve`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.engine import resolve_device
from ..models import lm

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    output: list[int] = field(default_factory=list)
    done: bool = False
    # True when the wave's cache filled before the request reached
    # max_new_tokens/EOS — done, but with fewer tokens than asked for
    truncated: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, model: lm.LM, *, batch_slots: int = 4,
                 cache_len: int = 256, device=None):
        if cfg.family in ("vlm", "audio"):
            raise ValueError(
                f"ServeEngine serves token requests only; {cfg.name}'s {cfg.family} family "
                "needs vision or memory beside the tokens in every decode step: serve it "
                "through make_serve_step (repro_torch.launch.serve)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"ServeEngine on {self.device}: the model lies on {model.device}")
        self.cfg = cfg
        self.model = model
        self.b = batch_slots
        self.cache_len = cache_len
        self._pending: list[Request] = []
        self.finished: list[Request] = []
        self.steps_executed = 0

    def submit(self, req: Request) -> None:
        self._pending.append(req)

    def _step(self, state, tokens):
        logits, state = lm.decode_step(self.cfg, self.model, state, tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _run_wave(self, wave: list[Request]) -> None:
        state = lm.init_decode_state(self.cfg, self.b, self.cache_len, device=self.device)
        tokens = np.zeros(self.b, np.int32)
        cursor = np.zeros(self.b, np.int64)   # position in prompt
        active = np.zeros(self.b, bool)
        for i, req in enumerate(wave):
            tokens[i] = req.prompt[0] if req.prompt else 0
            active[i] = True

        while active.any() and int(np.max(cursor)) < self.cache_len - 1:
            next_tok, state = self._step(state, torch.tensor(tokens, device=self.device))
            self.steps_executed += 1
            next_np = next_tok.cpu().numpy()
            for i, req in enumerate(wave):
                if not active[i]:
                    continue
                cursor[i] += 1
                if cursor[i] < len(req.prompt):
                    tokens[i] = req.prompt[int(cursor[i])]  # teacher-force
                    continue
                tok = int(next_np[i])
                req.output.append(tok)
                tokens[i] = tok
                if (len(req.output) >= req.max_new_tokens
                        or (req.eos_id is not None and tok == req.eos_id)):
                    active[i] = False
                    req.done = True
                    self.finished.append(req)
        for i, req in enumerate(wave):  # cache-length retirement
            if active[i]:
                req.done = True
                req.truncated = True
                self.finished.append(req)

    def run_until_drained(self) -> list[Request]:
        while self._pending:
            wave = self._pending[: self.b]
            self._pending = self._pending[self.b:]
            self._run_wave(wave)
        return self.finished
