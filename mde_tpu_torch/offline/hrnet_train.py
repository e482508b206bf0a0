"""Semantic-segmentation training for the zoo's models (HRNetV2-W48 + C1
and the others of `semseg_zoo.py`), the port of
`mde_tpu/offline/hrnet_train.py` (:1-79): the capability of the reference's
semantic-segmentation-pytorch/train.py:93-140 (per-pixel NLL with an ignore
label, SGD with poly learning-rate decay).

The model trains in its own float32 (or under `layers.cast_at_use`), every
BatchNorm in training mode with flax's running-stat update
(`layers.BatchNorm2d`). The optimizer is torch's SGD with momentum 0.9,
dampening 0 and `weight_decay` (the L2 term added to the gradient before the
momentum: optax's chain(add_decayed_weights, sgd)), under a LambdaLR with
the poly schedule; update k runs at the schedule's step k, as optax's count.
"""

import numpy as np
import torch

from .semseg_zoo import SegmentationModel


def poly_lr_schedule(base_lr: float, max_iters: int, power: float = 0.9):
    """step -> lr = base * (1 - step / max_iters) ** power, in float32 as
    optax computes it (the reference's train.py:126-131)."""
    f32 = np.float32

    def schedule(step):
        frac = f32(1.0) - f32(min(f32(step), f32(max_iters))) / f32(max_iters)
        return float(f32(f32(base_lr) * f32(frac ** f32(power))))

    return schedule


def segmentation_loss(log_probs, labels, ignore_index: int = -1):
    """Per-pixel NLL with an ignore label: log_probs (N, C, H, W), labels
    (N, H, W) class ids, -1 ignored."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    ll = torch.gather(log_probs, 1, safe[:, None])[:, 0]
    return -torch.where(valid, ll, 0.0).sum() / valid.sum().clamp(min=1).to(ll.dtype)


def pixel_accuracy(log_probs, labels, ignore_index: int = -1):
    valid = labels != ignore_index
    correct = ((torch.argmax(log_probs, dim=1) == labels) & valid).sum()
    return correct.to(torch.float32) / valid.sum().clamp(min=1).to(torch.float32)


def build_semseg_optimizer(model: torch.nn.Module, base_lr: float = 0.02,
                           max_iters: int = 150000, momentum: float = 0.9,
                           weight_decay: float = 1e-4):
    """SGD + poly decay + L2 (the reference's TRAIN: lr 0.02, power 0.9,
    beta1 0.9, wd 1e-4). Returns (optimizer, scheduler); call
    `scheduler.step()` after each `optimizer.step()`."""
    opt = torch.optim.SGD(model.parameters(), lr=base_lr, momentum=momentum, dampening=0.0,
                          weight_decay=weight_decay)
    sched = poly_lr_schedule(base_lr, max_iters)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: sched(k) / base_lr)


def make_semseg_train_step(model: SegmentationModel, optimizer, scheduler):
    """step(images (N, 3, H, W) float32, labels (N, h, w) int at the model's
    output resolution, -1 ignored) -> {"loss", "acc"} as 0-dim device
    tensors, for any model of the zoo (HRNetV2-W48 + C1 among them), as the
    JAX step takes any: one forward in training mode (log-softmax at the
    model's resolution, 1/4 of the input for HRNet), the loss, the backward,
    an SGD update and the schedule's step. Reads nothing back to the host."""

    def step(images, labels):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        log_probs = model(images)
        loss = segmentation_loss(log_probs, labels)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {"loss": loss.detach(), "acc": pixel_accuracy(log_probs.detach(), labels)}

    return step
