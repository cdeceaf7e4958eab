"""The LM substrate on PyTorch: the dense, moe, hybrid and ssm families'
forward (with the hand-written ``flash_attention`` kernel and its
backward), their train step, and their cached decode."""
from . import lm, moe, ssm, steps
from .steps import (
    input_specs, make_prefill_step, make_serve_step, make_train_step, supports_shape,
)

__all__ = ["lm", "moe", "ssm", "steps", "make_train_step", "make_serve_step", "make_prefill_step",
           "input_specs", "supports_shape"]
