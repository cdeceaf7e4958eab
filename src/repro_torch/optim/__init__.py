"""Hand-rolled optimizers: AdamW and momentum SGD with float32 moments,
and learning-rate schedules.  The int8 gradient compression of the
reference (``repro/optim/compress.py``) shards a step over a mesh and
waits for the second half of ROADMAP A13b."""
from .adamw import adamw_init, adamw_update, sgdm_init, sgdm_update
from .schedules import cosine_schedule, linear_warmup

__all__ = ["adamw_init", "adamw_update", "sgdm_init", "sgdm_update",
           "cosine_schedule", "linear_warmup"]
