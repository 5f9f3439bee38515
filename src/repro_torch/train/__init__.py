"""The port's single-device trainer: the train step and the training
loop with checkpoint/restart and selection in the loop."""

from repro_torch.train.loop import LoopResult, LoopState, train_loop
from repro_torch.train.step import (
    TrainState,
    init_train_state,
    make_train_step,
)

__all__ = [
    "LoopResult",
    "LoopState",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "train_loop",
]
