from .loop import make_loss_fn, make_train_step
from .optim import OneCycleAdamW, onecycle_lr_schedule, onecycle_momentum_schedule
from .state import TrainState, create_train_state

__all__ = ["make_loss_fn", "make_train_step", "OneCycleAdamW", "onecycle_lr_schedule",
           "onecycle_momentum_schedule", "TrainState", "create_train_state"]
