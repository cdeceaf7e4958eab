"""Hand-rolled optimizers: AdamW and momentum SGD with float32 moments,
learning-rate schedules, and the int8 gradient compression with error
feedback of a data-parallel loop."""
from .adamw import adamw_init, adamw_update, global_norm, sgdm_init, sgdm_update
from .compress import compress_int8, compressed_psum, decompress_int8, error_feedback_init
from .schedules import cosine_schedule, linear_warmup

__all__ = ["adamw_init", "adamw_update", "global_norm", "sgdm_init", "sgdm_update",
           "cosine_schedule", "linear_warmup", "compress_int8", "decompress_int8",
           "compressed_psum", "error_feedback_init"]
