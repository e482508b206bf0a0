"""Train state, port of `mde_tpu/train/state.py`: the model (its parameters
and its BatchNorm running stats), the optimizer and the update count."""

from dataclasses import dataclass

import torch

from .optim import OneCycleAdamW


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: OneCycleAdamW
    step: int = 0


def create_train_state(model: torch.nn.Module, args, steps_per_epoch: int) -> TrainState:
    """Wrap a built model (weights already loaded or initialised) with the
    reference optimizer recipe (train/optim.py)."""
    return TrainState(model=model, optimizer=OneCycleAdamW(model, args, steps_per_epoch))
