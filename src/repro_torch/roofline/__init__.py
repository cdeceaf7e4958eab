"""Roofline terms with H100 constants, and the model-FLOPs count."""
from .analysis import HW, model_flops, parse_shape_bytes, roofline_terms

__all__ = ["HW", "model_flops", "parse_shape_bytes", "roofline_terms"]
