"""Roofline terms with H100 constants, the model-FLOPs count, collective
wire bytes, and a step's per-device cost counted at dispatch."""
from .analysis import HW, collective_bytes, model_flops, parse_shape_bytes, roofline_terms

__all__ = ["HW", "collective_bytes", "model_flops", "parse_shape_bytes", "roofline_terms"]
