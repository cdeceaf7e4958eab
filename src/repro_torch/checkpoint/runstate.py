"""Per-iteration run snapshots for ``Plan``/``StreamingPlan`` resume.

A *run state* is everything needed to continue an iteration loop
bit-identically for integer/boolean attributes: the state tree at an
iteration boundary, the absolute iteration counter, the loop-continue
flag the algorithm's ``after`` hook last returned, and — when the run
uses direction optimization — the :class:`DirectionController`'s latch
state and decision history (its hysteresis depends on both).  Nothing
else is RNG- or time-dependent, so the snapshot is closed under
replay: ``resume()`` from any boundary produces the same final
integers as the uninterrupted run.

The payload rides the :mod:`repro_torch.checkpoint.ckpt` substrate
(atomic ``os.replace`` writes, sha256-verified ``LATEST`` pointer),
stored as one tree ``{"state": ..., "meta": ...}`` — the reference
package's layout, so either package resumes the other's snapshots.
Every meta field is an array leaf with a FIXED dtype so the restore
template never depends on what was saved: variable-length history
fields use zero-length arrays as templates.  Direction decisions are
coded ``push=0 / pull=1``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .ckpt import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["RunSnapshot", "save_runstate", "load_runstate",
           "latest_runstate_step"]

_DIR_CODES = {"push": 0, "pull": 1}
_DIR_NAMES = {v: k for k, v in _DIR_CODES.items()}


@dataclass
class RunSnapshot:
    """One restorable iteration boundary."""

    state: Any             # the state tree at the boundary
    it: int                # iterations completed (the next one to run)
    cont: bool             # the loop-continue flag after iteration it-1
    ctrl: dict | None      # direction-controller restore dict, or None
    step: int              # checkpoint step the snapshot came from


def _meta(it: int, cont: bool, ctrl) -> dict:
    """Always-emit every field with its fixed dtype — the restore
    template is then independent of which run wrote the snapshot."""
    has_ctrl = ctrl is not None
    decisions = list(ctrl.decisions) if has_ctrl else []
    densities = list(ctrl.densities) if has_ctrl else []
    return dict(
        it=np.int64(it),
        cont=np.bool_(cont),
        has_ctrl=np.bool_(has_ctrl),
        dir_current=np.int8(
            _DIR_CODES[ctrl.current] if has_ctrl else 0),
        dir_switches=np.int64(ctrl.switches if has_ctrl else 0),
        dir_decisions=np.asarray(
            [_DIR_CODES[d] for d in decisions], np.int8),
        dir_densities=np.asarray(densities, np.float64),
    )


def _meta_template() -> dict:
    """Dtype-bearing template; zero-length arrays stand in for the
    variable-length history fields (restore is shape-free)."""
    return _meta(0, True, None)


def save_runstate(ckpt_dir: str, state, *, it: int, cont: bool,
                  ctrl=None, step: int | None = None) -> str:
    """Atomically persist one iteration boundary; returns the path.

    ``state`` may hold tensors on any device (they are copied to the
    host) or numpy arrays.  ``ctrl`` is a live
    :class:`~repro_torch.core.direction.DirectionController` (or
    ``None`` for runs without direction optimization); only its
    replay-relevant fields are stored.  ``step`` defaults to ``it`` —
    one snapshot per boundary, later saves at the same boundary
    overwrite."""
    payload = {"state": dict(state), "meta": _meta(it, cont, ctrl)}
    return save_checkpoint(ckpt_dir, it if step is None else step, payload)


def load_runstate(ckpt_dir: str, state_template,
                  step: int | None = None) -> RunSnapshot:
    """Restore the latest (or ``step``'s) snapshot into
    ``state_template``'s structure and dtypes.

    ``state_template`` is what ``alg.init_state(store)`` returns — the
    restore casts every stored leaf back to the template dtype, so
    integer/boolean attributes round-trip exactly.  The state's leaves
    come back as numpy arrays; ``run`` moves them to the plan's
    device."""
    template = {"state": dict(state_template), "meta": _meta_template()}
    payload, got = restore_checkpoint(ckpt_dir, template, step=step)
    meta = payload["meta"]
    ctrl = None
    if bool(meta["has_ctrl"]):
        ctrl = dict(
            current=_DIR_NAMES[int(meta["dir_current"])],
            switches=int(meta["dir_switches"]),
            decisions=[_DIR_NAMES[int(d)]
                       for d in np.asarray(meta["dir_decisions"])],
            densities=[float(x)
                       for x in np.asarray(meta["dir_densities"])],
        )
    return RunSnapshot(state=payload["state"], it=int(meta["it"]),
                       cont=bool(meta["cont"]), ctrl=ctrl, step=int(got))


def latest_runstate_step(ckpt_dir: str) -> int | None:
    """Newest restorable boundary (the verified ``LATEST`` pointer)."""
    return latest_step(ckpt_dir)
