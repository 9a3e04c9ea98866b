"""Training / evaluation loop (L5), metrics and statistics."""
from .stats import EpochStats
from .metrics import MetricsLogger
from .trainer import NonFiniteError, TrainConfig, Trainer

__all__ = ["EpochStats", "MetricsLogger", "NonFiniteError", "TrainConfig",
           "Trainer"]
