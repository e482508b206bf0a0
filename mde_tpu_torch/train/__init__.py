from .driver import main_train
from .loop import make_eval_step, make_loss_fn, make_train_step, validate
from .optim import OneCycleAdamW, onecycle_lr_schedule, onecycle_momentum_schedule
from .state import TrainState, create_train_state, wrap_ddp

__all__ = ["main_train", "make_eval_step", "make_loss_fn", "make_train_step", "validate",
           "OneCycleAdamW", "onecycle_lr_schedule", "onecycle_momentum_schedule", "TrainState",
           "create_train_state", "wrap_ddp"]
