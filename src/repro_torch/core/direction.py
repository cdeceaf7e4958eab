"""Per-iteration push/pull direction optimization (GraphBLAST/GraphIt
style direction switching over PGAbB's block kernels).

Frontier algorithms default to a *push* step: every active vertex
scatters along its out-edges.  On scale-free graphs the frontier
quickly covers a large fraction of the vertices, and a *pull* step —
every still-undecided vertex gathers from its in-neighbors and stops at
the first hit — touches far fewer edges.  An algorithm opts in by
declaring both kernel variants plus a ``metadata["direction"]``
capability::

    BlockAlgorithm(
        ...,
        kernel_sparse=push_scatter,
        kernel_sparse_pull=pull_gather,         # same signature/contract
        kernel_dense=push_tiles,                # optional; if present,
        kernel_dense_pull=pull_tiles,           # the pull twin is required
        metadata=dict(
            ...,
            direction=dict(frontier="nf", beta=24.0),
        ),
    )

``frontier`` names the state leaf the executor reads to judge frontier
density (a bool mask, a scalar active-count, or a batched count
vector); ``beta`` is the Beamer-style cost ratio.  The contract every
pull variant must honor: **bit-identical results to the push variant
for integer/bool attributes from the same iteration-start state**, on
any sub-partition of the edges —
the executor freely substitutes one for the other per iteration, never
mixing directions within an iteration.

Decision rule (:class:`DirectionController`, deterministic, host-side,
hysteresis band like the hetero split / tail rebalancer):

* in push, switch to pull when ``count * beta > population``;
* in pull, switch back when ``count * beta < population * hysteresis``
  (default 0.75);
* inside the band, hold the current direction — a frontier hovering at
  the threshold cannot flap.

``REPRO_DIRECTION_BETA`` / ``REPRO_DIRECTION_HYSTERESIS`` override the
knobs; every decision lands in ``schedule_stats["direction"]`` and each
flip increments the ``stream.direction_switches`` counter and drops an
instant on the ``direction`` tracer lane.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from .. import obs
from .knobs import env_float as _env_float

if TYPE_CHECKING:  # pragma: no cover — typing only, avoids an import cycle
    from .functors import BlockAlgorithm

__all__ = [
    "DIRECTIONS", "BETA_DEFAULT", "HYSTERESIS_DEFAULT",
    "direction_spec", "resolve_direction", "kernels_for",
    "DirectionController",
]

#: Valid ``compile_plan(..., direction=...)`` values.  ``None`` keeps
#: the pre-direction behavior (plain push, single compiled step).
DIRECTIONS = ("push", "pull", "auto")

#: Beamer-style cost ratio: pull wins once the frontier holds more than
#: ``population / beta`` active vertices (direction-optimizing BFS uses
#: edge counts with alpha≈14; at PGAbB's block granularity a vertex
#: ratio with beta≈24 lands the switch in the same place on R-MAT).
BETA_DEFAULT = 24.0

#: Re-arm fraction of the switch threshold: once in pull, the frontier
#: must shrink below ``hysteresis`` × the threshold before the
#: controller returns to push.  The band keeps a frontier hovering at
#: the threshold from flapping.
HYSTERESIS_DEFAULT = 0.75


def direction_spec(alg: "BlockAlgorithm") -> dict | None:
    """Validated ``metadata["direction"]`` capability, or ``None``.

    A capable algorithm must name the frontier leaf and ship a pull
    twin for every declared push kernel — otherwise an auto/pull run
    would silently skip the work the missing variant covers.
    """
    spec = alg.metadata.get("direction")
    if spec is None:
        return None
    if not isinstance(spec, dict) or not spec.get("frontier"):
        raise ValueError(
            f"{alg.name}: metadata['direction'] must be a dict naming the "
            f"frontier state leaf, e.g. dict(frontier='nf', beta=24.0); "
            f"got {spec!r}"
        )
    if alg.kernel_sparse is not None and alg.kernel_sparse_pull is None:
        raise ValueError(
            f"{alg.name}: metadata['direction'] is declared but "
            f"kernel_sparse has no kernel_sparse_pull twin — a pull "
            f"iteration would drop the sparse path's work"
        )
    if alg.kernel_dense is not None and alg.kernel_dense_pull is None:
        raise ValueError(
            f"{alg.name}: metadata['direction'] is declared but "
            f"kernel_dense has no kernel_dense_pull twin — a pull "
            f"iteration would leave the dense-routed edges unprocessed"
        )
    return spec


def resolve_direction(alg: "BlockAlgorithm",
                      direction: str | None) -> str:
    """Validate a ``compile_plan`` direction request against ``alg``.

    ``None`` → ``"push"`` (the pre-direction default; only the push
    step is built).  ``"pull"``/``"auto"`` require the
    algorithm to declare the capability.
    """
    if direction is None:
        return "push"
    if direction not in DIRECTIONS:
        raise ValueError(
            f"direction must be one of {DIRECTIONS} (or None); "
            f"got {direction!r}"
        )
    if direction != "push" and direction_spec(alg) is None:
        raise ValueError(
            f"{alg.name} declares no metadata['direction'] capability; "
            f"direction={direction!r} requires push and pull kernel "
            f"variants"
        )
    return direction


def kernels_for(alg: "BlockAlgorithm", direction: str):
    """The (sparse, dense) kernel pair for one direction."""
    if direction == "pull":
        return alg.kernel_sparse_pull, alg.kernel_dense_pull
    return alg.kernel_sparse, alg.kernel_dense


def frontier_count(state, leaf: str, n: int) -> tuple[float, float]:
    """(active count, population) read from the frontier leaf.

    Bool leaves are per-vertex masks: count = popcount, population =
    the mask size.  Numeric leaves are active-vertex counts (scalar, or
    a batched per-query vector): count = their sum, population = ``n``
    per query.  Either way ``count/population`` is the frontier density
    the decision rule compares against ``1/beta``.
    """
    if leaf not in state:
        raise KeyError(
            f"direction frontier leaf {leaf!r} is missing from the state "
            f"(have {sorted(state)})"
        )
    a = state[leaf].cpu().numpy()
    if a.dtype == np.bool_:
        return float(a.sum()), float(max(a.size, 1))
    return float(a.sum()), float(n * max(a.size, 1))


class DirectionController:
    """Deterministic per-iteration push/pull decisions with hysteresis.

    One instance per ``run()`` — decisions and the switch count reset
    with the run, never leak across runs of a shared plan.  The
    decision depends only on the frontier-density trace (and the two
    knobs), so replaying a trace replays the decisions exactly — the
    property the Hypothesis harness pins down.
    """

    def __init__(self, alg: "BlockAlgorithm", mode: str, n: int) -> None:
        spec = direction_spec(alg) if mode != "push" else None
        spec = spec or {}
        self.mode = mode
        self.frontier = spec.get("frontier")
        self.beta = _env_float("REPRO_DIRECTION_BETA",
                               float(spec.get("beta", BETA_DEFAULT)))
        self.hysteresis = _env_float("REPRO_DIRECTION_HYSTERESIS",
                                     float(spec.get("hysteresis",
                                                    HYSTERESIS_DEFAULT)))
        if self.beta <= 0:
            raise ValueError(f"direction beta must be > 0; got {self.beta}")
        if not 0 < self.hysteresis <= 1:
            raise ValueError(
                f"direction hysteresis must be in (0, 1]; "
                f"got {self.hysteresis}"
            )
        self.n = int(n)
        self.current = "push"
        self.switches = 0
        self.decisions: list[str] = []
        self.densities: list[float] = []

    def decide_density(self, count: float, population: float) -> str:
        """Pure decision rule (also the unit-test surface): density
        above ``1/beta`` → pull; below ``hysteresis/beta`` → push;
        in between → hold."""
        if self.mode in ("push", "pull"):
            return self.mode
        score = count * self.beta
        if self.current == "push":
            return "pull" if score > population else "push"
        return "push" if score < population * self.hysteresis else "pull"

    def decide(self, state, it: int) -> str:
        """Decide iteration ``it``'s direction from iteration-start
        state; records the decision, density, and any switch."""
        if self.mode in ("push", "pull"):
            d, density = self.mode, float("nan")
        else:
            cnt, pop = frontier_count(state, self.frontier, self.n)
            d = self.decide_density(cnt, pop)
            density = cnt / pop if pop else 0.0
        if self.decisions and d != self.current:
            self.switches += 1
            obs.metrics.counter("stream.direction_switches").inc()
            obs.instant("direction_switch", lane="direction",
                        it=it, to=d, density=density)
        self.current = d
        self.decisions.append(d)
        self.densities.append(density)
        return d

    def stats(self) -> dict:
        """The ``schedule_stats["direction"]`` block."""
        return dict(
            mode=self.mode,
            beta=self.beta,
            hysteresis=self.hysteresis,
            decisions=list(self.decisions),
            switches=self.switches,
            pull_iterations=sum(d == "pull" for d in self.decisions),
            densities=list(self.densities),
        )
