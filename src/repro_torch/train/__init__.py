"""The port's trainer (the train step, single-device or data parallel
on a mesh, and the training loop with checkpoint/restart and selection
in the loop) and the continuous-batching serving engine."""

from repro_torch.train.engine import Request, ServeEngine, insert_slot
from repro_torch.train.loop import LoopResult, LoopState, train_loop
from repro_torch.train.step import (
    TrainState,
    gather_train_state,
    init_train_state,
    make_train_step,
    shard_train_state,
)

__all__ = [
    "LoopResult",
    "LoopState",
    "Request",
    "ServeEngine",
    "TrainState",
    "gather_train_state",
    "init_train_state",
    "insert_slot",
    "make_train_step",
    "shard_train_state",
    "train_loop",
]
