"""Data substrates: the deterministic synthetic token pipeline and the
graph benchmark suite."""
from .tokens import TokenPipeline, synthetic_batch
from .graphs import benchmark_suite

__all__ = ["TokenPipeline", "synthetic_batch", "benchmark_suite"]
