"""The train step and the fault-tolerant trainer.  Port of ``repro.train``."""

from repro_torch.train.step import TrainState, loss_fn, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["make_train_step", "loss_fn", "TrainState", "Trainer", "TrainerConfig"]
