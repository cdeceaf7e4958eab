"""Data substrates: the deterministic synthetic token pipeline.  The
graph datasets (``repro/data/graphs.py``) wait for ROADMAP A12a."""
from .tokens import TokenPipeline, synthetic_batch

__all__ = ["TokenPipeline", "synthetic_batch"]
