"""Training loop substrate."""
from .loop import TrainConfig, TrainLoop

__all__ = ["TrainLoop", "TrainConfig"]
