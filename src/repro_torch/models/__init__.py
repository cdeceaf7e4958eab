"""The LM substrate on PyTorch: the dense family's forward (with the
hand-written ``flash_attention`` kernel and its backward), its train
step, and its cached decode."""
from . import lm, steps
from .steps import (
    input_specs, make_prefill_step, make_serve_step, make_train_step, supports_shape,
)

__all__ = ["lm", "steps", "make_train_step", "make_serve_step", "make_prefill_step",
           "input_specs", "supports_shape"]
