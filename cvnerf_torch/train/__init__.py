"""Training: state, the train step, the host loop, checkpointing."""

from cvnerf_torch.train.state import (TrainState, create_train_state,
                                      make_lr_schedule)
from cvnerf_torch.train.loop import TrainConfig, make_train_step, Trainer

__all__ = [
    "TrainState",
    "create_train_state",
    "make_lr_schedule",
    "TrainConfig",
    "make_train_step",
    "Trainer",
]
