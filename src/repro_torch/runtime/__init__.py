"""The fault-tolerant training loop of the port (reference:
``repro/runtime``)."""
from repro_torch.runtime.monitor import FailureInjector, StragglerMonitor
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "StragglerMonitor", "FailureInjector"]
