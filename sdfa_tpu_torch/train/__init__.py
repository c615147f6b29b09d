from . import checkpoints, lr_schedules
from .trainer import Experiment, Trainer, make_loss_fn, make_optimizer

__all__ = ["Experiment", "Trainer", "checkpoints", "lr_schedules", "make_loss_fn",
           "make_optimizer"]
