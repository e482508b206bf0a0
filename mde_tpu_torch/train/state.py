"""Train state, port of `mde_tpu/train/state.py`: the model (its parameters
and its BatchNorm running stats), the optimizer and the update count; with
several ranks, also the model's DistributedDataParallel wrapper, through
which the step runs its forward (`wrap_ddp`)."""

from dataclasses import dataclass
from typing import Optional

import torch

from .optim import OneCycleAdamW


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: OneCycleAdamW
    step: int = 0
    ddp: Optional[torch.nn.Module] = None


def create_train_state(model: torch.nn.Module, args, steps_per_epoch: int) -> TrainState:
    """Wrap a built model (weights already loaded or initialised) with the
    reference optimizer recipe (train/optim.py)."""
    return TrainState(model=model, optimizer=OneCycleAdamW(model, args, steps_per_epoch))


def wrap_ddp(state: TrainState, device_ids=None) -> TrainState:
    """Wrap `state.model` in DistributedDataParallel on the default process
    group. Buffers are not broadcast: BatchNorm computes the global batch's
    moments on every rank (models/norm.py), so they stay equal. The
    encoder's last BatchNorm feeds no output that the decoder reads (it
    takes features 4, 5, 6, 8 and 11 of the encoder's list), so DDP leaves
    its two parameters out, and need not walk the autograd graph each step
    to find them; their gradient stays None on every rank and the optimizer
    gives them a zero one, as optax does. Any other parameter the loss
    missed would make DDP raise at the next step.

    Under tensor parallelism (`model.tp_layout`, models/tp.py) DDP averages
    the replicated parameters' gradients over the whole world: the m model
    ranks of a data index hold the same gradient, so that is the data mean,
    and it keeps the replicas equal bit for bit. The split parameters are
    left out too (DDP would average one rank's slice with another's); the
    optimizer averages them over their data group (train/optim.py)."""
    from torch.nn.parallel import DistributedDataParallel
    from ..parallel import plain_name
    layout = getattr(state.model, "tp_layout", None) or {}
    ignore = [name for name, _ in state.model.named_parameters()
              if plain_name(name) in layout
              or plain_name(name).startswith("encoder.original_model.bn2.")]
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(state.model, ignore)
    state.ddp = DistributedDataParallel(state.model, device_ids=device_ids,
                                        broadcast_buffers=False)
    return state
