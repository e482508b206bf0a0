"""Optimizer: AdamW under a OneCycle schedule with a global-norm clip, port
of `mde_tpu/train/optim.py` (reference train.py:345-368, 427).

* The lr follows torch's OneCycleLR (anneal 'cos'): from max_lr / div up to
  max_lr at 30 % of the steps, then down to max_lr / (div * final_div); beta1
  is cycled 0.95 -> 0.85 -> 0.95 in the opposite phase. Both are set on the
  optimizer before every update from `onecycle_lr_schedule` and
  `onecycle_momentum_schedule`, evaluated at the update's index (0 first), as
  optax's `inject_hyperparams` evaluates them at its count.
* Gradients are clipped to global norm 0.1 before the update.
* Weight decay applies to every parameter. `--encoder_lr_factor` scales the
  lr of the `encoder.*` parameters (uniform by default, the reference as it
  actually runs; `--same_lr` turns the factor off), which scales their whole
  AdamW update including the decay, as the JAX package's update-scale mask
  does.
* Tensor parallelism (`model.tp_layout`, models/tp.py): a split parameter
  is this rank's slice. Its gradient is averaged over its data group here
  (DDP leaves it out: train/state.py), and the clip's global norm adds the
  squares of the slices' gradients over the model group to those of the
  replicated gradients, counted once. AdamW is elementwise, so each rank
  updates its slices as one process updates the whole tensors.
"""

import math
from typing import Callable

import torch
import torch.distributed as dist

from ..parallel import model_group, plain_name, sync_group

_MAX_GRAD_NORM = 0.1  # reference train.py:427


def _cos_anneal(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def onecycle_lr_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3,
                         div_factor: float = 25.0,
                         final_div_factor: float = 1e4) -> Callable[[int], float]:
    """torch.optim.lr_scheduler.OneCycleLR (anneal_strategy='cos')."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    step_up = float(pct_start * total_steps) - 1.0
    step_down = float(total_steps - 1) - step_up

    def schedule(step: int) -> float:
        if step <= step_up:
            return _cos_anneal(initial_lr, max_lr, min(max(step / max(step_up, 1.0), 0.0), 1.0))
        pct = min(max((step - step_up) / max(step_down, 1.0), 0.0), 1.0)
        return _cos_anneal(max_lr, min_lr, pct)

    return schedule


def onecycle_momentum_schedule(total_steps: int, base_momentum: float = 0.85,
                               max_momentum: float = 0.95,
                               pct_start: float = 0.3) -> Callable[[int], float]:
    """Momentum (beta1) cycling opposite to the lr: max -> base -> max."""
    step_up = float(pct_start * total_steps) - 1.0
    step_down = float(total_steps - 1) - step_up

    def schedule(step: int) -> float:
        if step <= step_up:
            pct = min(max(step / max(step_up, 1.0), 0.0), 1.0)
            return _cos_anneal(max_momentum, base_momentum, pct)
        pct = min(max((step - step_up) / max(step_down, 1.0), 0.0), 1.0)
        return _cos_anneal(base_momentum, max_momentum, pct)

    return schedule


class OneCycleAdamW:
    """torch AdamW (b2 0.999, eps 1e-8) whose lr and beta1 are set per update
    from the OneCycle schedules, after a global-norm clip of the gradients."""

    def __init__(self, model: torch.nn.Module, args, steps_per_epoch: int):
        total_steps = args.epochs * steps_per_epoch
        self.lr = onecycle_lr_schedule(args.lr, total_steps, div_factor=args.div_factor,
                                       final_div_factor=args.final_div_factor)
        self.beta1 = onecycle_momentum_schedule(total_steps)
        factor = 1.0 if args.same_lr else float(args.encoder_lr_factor or 1.0)
        encoder, rest = [], []
        for name, p in model.named_parameters():
            (encoder if name.startswith("encoder.") else rest).append((plain_name(name), p))
        groups = [{"params": [p for _, p in rest], "lr_scale": 1.0}]
        if encoder:
            groups.append({"params": [p for _, p in encoder], "lr_scale": factor})
        # one-process names, in the order of the optimizer's state indices
        self.names = [name for name, _ in rest + encoder]
        self.params = [p for _, p in rest + encoder]
        layout = getattr(model, "tp_layout", None) or {}
        self.split = [name in layout for name in self.names]
        self.optimizer = torch.optim.AdamW(groups, lr=self.lr(0), betas=(self.beta1(0), 0.999),
                                           eps=1e-8, weight_decay=args.wd)

    def step(self, step: int) -> torch.Tensor:
        """Clip, then apply update number `step` (0 first). Returns the
        gradients' global norm before the clip. A parameter the loss does not
        reach (the encoder's last BN feeds no output) gets a zero gradient,
        so that weight decay still moves it, as optax does."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if any(self.split):
            norm = self._clip_split()
        else:
            norm = torch.nn.utils.clip_grad_norm_(self.params, _MAX_GRAD_NORM)
        lr, beta1 = self.lr(step), self.beta1(step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
            group["betas"] = (beta1, 0.999)
        self.optimizer.step()
        return norm

    def _clip_split(self) -> torch.Tensor:
        """Under tensor parallelism: the slices' gradients averaged over
        their data group, then clipped with `clip_grad_norm_`'s rule to the
        global norm of the whole tensors; returns that norm."""
        split = [p.grad for p, s in zip(self.params, self.split) if s]
        if sync_group() is not None:
            for g in split:
                dist.all_reduce(g, group=sync_group())
            torch._foreach_div_(split, dist.get_world_size(sync_group()))
        grads = [p.grad for p in self.params]
        squares = torch.stack(torch._foreach_norm(grads)) ** 2
        mask = torch.tensor(self.split, device=squares.device)
        split_sum = torch.where(mask, squares, 0.0).sum()
        if model_group() is not None:
            dist.all_reduce(split_sum, group=model_group())
        norm = (split_sum + torch.where(mask, 0.0, squares).sum()).sqrt()
        torch._foreach_mul_(grads, torch.clamp(_MAX_GRAD_NORM / (norm + 1e-6), max=1.0))
        return norm

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)
