"""Evaluation loop (L5) and statistics."""
from .stats import EpochStats
from .trainer import TrainConfig, Trainer

__all__ = ["EpochStats", "TrainConfig", "Trainer"]
