"""Deterministic fault injection at the executor's seams.

Chaos testing for the streaming runtime: a :class:`FaultPlan` holds a
small set of rules, each naming an injection **site** (a seam the
executor fires explicitly), an **action**, and a **trigger**.  Sites:

======================  ================================================
``stage.assemble``      slab assembly (staging worker thread, or the
                        main thread when ``pipeline_depth=0``)
``stage.device_put``    host→device slab copy (fired on the thread that
                        issues it, before the copy is queued)
``wave.compute``        one wave's step (per-iteration step for the
                        in-core :class:`~repro_torch.core.engine.Plan`)
``host.task``           one host-lane unit (the ``repro-host`` pool)
``mesh.collective``     the per-wave mesh fold (ROADMAP A10)
``serve.query``         one batch of the graph server (:mod:`repro_torch.serve.graphserve`)
======================  ================================================

Spec grammar (``compile_plan(faults=...)`` or ``REPRO_FAULTS``)::

    spec    := rule (';' rule)*
    rule    := site ':' action [':' trigger]
    action  := 'raise' | 'oom' | 'delay(<seconds>)' | 'corrupt'
    trigger := 'once' | 'every(<k>)' | 'at(<k>)'      # default: once

``raise`` throws :class:`InjectedFault`; ``oom`` throws
:class:`InjectedOOM` (classified like a real
``torch.cuda.OutOfMemoryError`` by
:func:`repro_torch.core.resilience.is_oom`); ``delay(s)`` sleeps;
``corrupt`` returns a corrupted copy of the value passing through the
site, never altering the value itself (recovery must discard it).
``at(k)`` matches when the site's ``wave=`` context equals ``k``
(falling back to the per-rule occurrence ordinal for sites without a
wave index); ``every(k)`` fires on every k-th occurrence.

Determinism: no randomness anywhere — rules fire on per-rule occurrence
counters, so the same plan over the same run fires at the same places
every time.  Disabled is free: plans hold ``self._faults = None`` and
every seam is one ``is not None`` check.

Example::

    >>> fp = FaultPlan.parse("wave.compute:raise:at(2)")
    >>> fp.rules[0].site, fp.rules[0].action, fp.rules[0].trigger
    ('wave.compute', 'raise', 'at')
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "SITES", "FaultPlan", "FaultRule", "InjectedFault", "InjectedOOM",
]

SITES = (
    "stage.assemble", "stage.device_put", "wave.compute",
    "host.task", "mesh.collective", "serve.query",
)

ACTIONS = ("raise", "oom", "delay", "corrupt")
TRIGGERS = ("once", "every", "at")

_ARG_RE = re.compile(r"^([a-z_]+)\((-?[0-9.]+)\)$")


class InjectedFault(RuntimeError):
    """An injected failure; carries its site and firing context."""

    def __init__(self, site: str, **ctx) -> None:
        detail = ", ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
        super().__init__(f"injected fault at {site}"
                         + (f" ({detail})" if detail else ""))
        self.site = site
        self.ctx = ctx


class InjectedOOM(InjectedFault):
    """An injected device out-of-memory (classified like a real
    ``torch.cuda.OutOfMemoryError`` by the resilience policy)."""


def _parse_head(token: str, kind: str, known: tuple) -> tuple[str, float]:
    """``'delay(0.5)'`` → ``('delay', 0.5)``; ``'raise'`` → ``('raise', 0)``."""
    m = _ARG_RE.match(token)
    name, arg = (m.group(1), float(m.group(2))) if m else (token, 0.0)
    if name not in known:
        raise ValueError(
            f"unknown fault {kind} {token!r} (known: {', '.join(known)})")
    if name in ("delay", "every", "at") and m is None:
        raise ValueError(f"fault {kind} {name!r} needs an argument, "
                         f"e.g. {name}(2)")
    if name in ("raise", "oom", "corrupt", "once") and m is not None:
        raise ValueError(f"fault {kind} {name!r} takes no argument")
    return name, arg


@dataclass
class FaultRule:
    """One parsed ``site:action[:trigger]`` rule with its hit counter."""

    site: str
    action: str            # raise | oom | delay | corrupt
    arg: float = 0.0       # delay seconds
    trigger: str = "once"  # once | every | at
    k: int = 0             # every/at argument
    seen: int = 0          # occurrences of the site (this rule's view)
    fired: int = 0

    def should_fire(self, wave: int | None) -> bool:
        self.seen += 1
        if self.trigger == "once":
            return self.fired == 0
        if self.trigger == "every":
            return self.seen % self.k == 0
        # at(k): first occurrence whose wave index (or ordinal, for
        # sites without one) equals k.  Single-shot so a recovered
        # retry of the same wave does not re-fire forever.
        ordinal = wave if wave is not None and wave >= 0 else self.seen - 1
        return ordinal == self.k and self.fired == 0


@dataclass
class FaultPlan:
    """A parsed, stateful set of injection rules.

    One instance per compiled plan — counters advance as sites fire, so
    a plan reused across runs keeps injecting per its ``every``/``once``
    semantics deterministically.
    """

    rules: list[FaultRule] = field(default_factory=list)
    injected: int = 0

    @classmethod
    def parse(cls, spec: "str | FaultPlan | None") -> "FaultPlan | None":
        """Parse a spec string (``None``/empty → ``None`` = disabled)."""
        if spec is None:
            return None
        if isinstance(spec, FaultPlan):
            return spec
        rules = []
        for part in str(spec).split(";"):
            part = part.strip()
            if not part:
                continue
            bits = [b.strip() for b in part.split(":")]
            if len(bits) not in (2, 3):
                raise ValueError(
                    f"malformed fault rule {part!r}: expected "
                    "site:action[:trigger]")
            site = bits[0]
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} "
                    f"(known: {', '.join(SITES)})")
            action, arg = _parse_head(bits[1], "action", ACTIONS)
            trigger, karg = ("once", 0.0)
            if len(bits) == 3:
                trigger, karg = _parse_head(bits[2], "trigger", TRIGGERS)
            if trigger == "every" and int(karg) < 1:
                raise ValueError(f"every(k) needs k >= 1 in {part!r}")
            if trigger == "at" and int(karg) < 0:
                raise ValueError(f"at(k) needs k >= 0 in {part!r}")
            rules.append(FaultRule(site=site, action=action, arg=arg,
                                   trigger=trigger, k=int(karg)))
        return cls(rules=rules) if rules else None

    def fire(self, site: str, value=None, **ctx):
        """Pass ``value`` through ``site``: may raise, sleep, or return
        a corrupted copy.  The executor calls this only when the plan's
        fault handle is non-``None``."""
        wave = ctx.get("wave")
        for r in self.rules:
            if r.site != site:
                continue
            if not r.should_fire(wave):
                continue
            r.fired += 1
            self.injected += 1
            if r.action == "raise":
                raise InjectedFault(site, **ctx)
            if r.action == "oom":
                raise InjectedOOM(site, **ctx)
            if r.action == "delay":
                time.sleep(r.arg)
            elif r.action == "corrupt":
                value = _corrupt(value)
        return value

    def reset(self) -> None:
        """Rewind every trigger counter so a reused plan re-injects
        from scratch."""
        self.injected = 0
        for r in self.rules:
            r.seen = 0
            r.fired = 0

    def stats(self) -> dict:
        """Per-rule firing counts for ``schedule_stats["resilience"]``."""
        return dict(
            injected=self.injected,
            rules=[dict(site=r.site, action=r.action, trigger=r.trigger,
                        k=r.k, fired=r.fired) for r in self.rules],
        )


def _damage(leaf):
    """One leaf's deterministic damage: ``~x`` for bool, ``x + 1`` for
    numbers; a tensor stays on its device, and the input is never
    altered in place."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bool:
            return torch.logical_not(leaf)
        return leaf if leaf.is_complex() else leaf + 1
    arr = np.asarray(leaf)
    if arr.dtype == np.bool_:
        return ~arr
    if arr.dtype.kind in "iuf":
        return arr + arr.dtype.type(1)
    return leaf


def _corrupt(value):
    """A deterministically wrong copy of ``value`` (dicts, lists and
    tuples rebuilt, every array or tensor leaf damaged; ``None`` passes
    through)."""
    if value is None:
        return None
    if isinstance(value, dict):
        return {k: _corrupt(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_corrupt(v) for v in value)
    return _damage(value)
