"""Share-gated step caching for the in-core executor.

Built steps are cached process-wide under the algorithm's identity —
``(algorithm name, step-affecting params, device type, direction)`` —
so two plans for the same algorithm share one step object, and
:attr:`repro_torch.core.engine.Plan.compile_count` counts the steps
actually built.  PyTorch runs eagerly, so a "step" is the Python
closure over the algorithm's kernels; nothing is traced or compiled.

Execution-time configuration must never enter a cache key: it does not
affect the step.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, TypeVar

from .. import obs

if TYPE_CHECKING:  # pragma: no cover — typing only, avoids an import cycle
    from .functors import BlockAlgorithm

__all__ = ["alg_cache_key", "shared_entry"]

T = TypeVar("T")


def alg_cache_key(alg: "BlockAlgorithm", backend: str,
                  direction: str = "push") -> tuple:
    """Algorithms are identified by (name, step-affecting params,
    backend, kernel direction).

    Factories record step-affecting parameters under
    ``metadata["params"]``; two factory calls with equal params produce
    behaviourally identical kernels and may share a step.  The
    ``direction`` component keys the push/pull kernel variant
    (:mod:`repro_torch.core.direction`) so each direction is built
    exactly once.
    """
    params = alg.metadata.get("params")
    return (alg.name, repr(sorted(params.items())) if params else None,
            backend, direction)


def shared_entry(cache: dict, key: tuple, factory: Callable[[], T], *,
                 share: bool = True) -> T:
    """The share-gated cache lookup.  ``share=False`` bypasses the cache
    for ad-hoc algorithms that reuse a registered name with different
    kernels."""
    if not share:
        obs.metrics.counter("compile.cache.bypasses").inc()
        return factory()
    entry = cache.get(key)
    if entry is None:
        obs.metrics.counter("compile.cache.misses").inc()
        entry = cache[key] = factory()
    else:
        obs.metrics.counter("compile.cache.hits").inc()
    return entry
