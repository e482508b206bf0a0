"""Detector training data and optimizer recipe, the port of
`mde_tpu/offline/detection_data.py` (:1-156): the DETR-style AutoAugment
policy of the reference's ade20k config (random flip, then either one
keep-ratio resize of SCALES_MAIN, or a resize of SCALES_PRE_CROP, a random
crop within CROP_RANGE and a resize of SCALES_MAIN), normalisation and /32
padding, the static GT padding, and AdamW with the paramwise no-decay set,
mmcv's linear warmup and the step decay at epochs 27 and 33.

Host-side numpy over (image uint8 HWC, boxes (G, 4), labels (G,), masks
(G, H, W) uint8), with the same draws from the caller's numpy Generator as
the JAX module, so one seed gives the same sample. The image goes through
`resize_bilinear_pil` and the masks through `resize_nearest_pil`, both
Pillow's bytes. The scale sets are arguments (`AugScales`), not module
globals.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from ..data.transforms import resize_bilinear_pil, resize_nearest_pil

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)
SCALES_MAIN = [(480, 1333), (512, 1333), (544, 1333), (576, 1333), (608, 1333),
               (640, 1333), (672, 1333), (704, 1333), (736, 1333), (768, 1333),
               (800, 1333)]
SCALES_PRE_CROP = [(400, 1333), (500, 1333), (600, 1333)]
CROP_RANGE = (384, 600)
MAX_GT = 100


class AugScales(NamedTuple):
    """The policy's (short, long max) scale sets and the crop's side range."""
    main: tuple = tuple(SCALES_MAIN)
    pre_crop: tuple = tuple(SCALES_PRE_CROP)
    crop_range: tuple = CROP_RANGE


def fixed_scales(short: int, long_max: int) -> AugScales:
    """One (short, long) pair for every resize and a crop of `short`: the
    JAX CLI's --fixed-scale (`scripts/train_detector.py:52-57`)."""
    return AugScales(((short, long_max),), ((short, long_max),), (short, short))


def _resize_keep_ratio(img, boxes, masks, short, long_max):
    h, w = img.shape[:2]
    scale = min(short / min(h, w), long_max / max(h, w))
    th, tw = int(h * scale + 0.5), int(w * scale + 0.5)
    img_r = resize_bilinear_pil(img, (tw, th))
    masks_r = None
    if masks is not None and len(masks):
        masks_r = np.stack([resize_nearest_pil(m, (tw, th)) for m in masks])
    return img_r, boxes * scale, masks_r


def _random_crop(rng, img, boxes, labels, masks, crop_range):
    h, w = img.shape[:2]
    ch = int(rng.integers(crop_range[0], min(crop_range[1], h) + 1)) if h > crop_range[0] else h
    cw = int(rng.integers(crop_range[0], min(crop_range[1], w) + 1)) if w > crop_range[0] else w
    y0 = int(rng.integers(0, max(h - ch, 0) + 1))
    x0 = int(rng.integers(0, max(w - cw, 0) + 1))
    img_c = img[y0:y0 + ch, x0:x0 + cw]
    boxes_c = boxes - np.array([x0, y0, x0, y0], np.float32)
    boxes_c[:, 0::2] = boxes_c[:, 0::2].clip(0, cw)
    boxes_c[:, 1::2] = boxes_c[:, 1::2].clip(0, ch)
    keep = (boxes_c[:, 2] > boxes_c[:, 0]) & (boxes_c[:, 3] > boxes_c[:, 1])
    masks_c = masks[:, y0:y0 + ch, x0:x0 + cw] if masks is not None and len(masks) else masks
    return (img_c, boxes_c[keep], labels[keep],
            masks_c[keep] if masks_c is not None and len(masks_c) else masks_c)


def autoaugment_sample(rng: np.random.Generator, img_u8, boxes, labels, masks,
                       scales: AugScales = AugScales()):
    """Flip + one of the two policies; returns (normalised image padded to
    /32 float32, boxes, labels, masks, valid (h, w))."""
    img, boxes = np.asarray(img_u8), np.asarray(boxes, np.float32)
    # RandomFlip p=.5 (before AutoAugment in the pipeline)
    if rng.random() < 0.5:
        img = np.ascontiguousarray(img[:, ::-1])
        w = img.shape[1]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if masks is not None and len(masks):
            masks = np.ascontiguousarray(masks[:, :, ::-1])
    if rng.random() < 0.5:
        short, lmax = scales.main[int(rng.integers(len(scales.main)))]
        img, boxes, masks = _resize_keep_ratio(img, boxes, masks, short, lmax)
    else:
        short, lmax = scales.pre_crop[int(rng.integers(len(scales.pre_crop)))]
        img, boxes, masks = _resize_keep_ratio(img, boxes, masks, short, lmax)
        img, boxes, labels, masks = _random_crop(rng, img, boxes, labels, masks,
                                                 scales.crop_range)
        short, lmax = scales.main[int(rng.integers(len(scales.main)))]
        img, boxes, masks = _resize_keep_ratio(img, boxes, masks, short, lmax)
    x = (img.astype(np.float32) - MEAN) / STD
    h, w = x.shape[:2]
    pad = np.zeros((((h + 31) // 32) * 32, ((w + 31) // 32) * 32, 3), np.float32)
    pad[:h, :w] = x
    return pad, boxes, labels, masks, (h, w)


def pad_gt(boxes, labels, masks, img_hw, max_gt: int = MAX_GT):
    """Annotations padded to the static capacity, with a validity mask. The
    masks stay uint8 ((max_gt, H, W) of {0, 1}; JAX's are float32 of the same
    values): a quarter of the bytes to copy to the card."""
    g = min(len(boxes), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_labels = np.zeros((max_gt,), np.int32)
    out_valid = np.zeros((max_gt,), bool)
    out_masks = np.zeros((max_gt, *img_hw), np.uint8)
    if g:
        out_boxes[:g] = boxes[:g]
        out_labels[:g] = labels[:g]
        out_valid[:g] = True
        if masks is not None and len(masks):
            mh, mw = masks.shape[1:]
            out_masks[:g, :mh, :mw] = masks[:g]
    return out_boxes, out_labels, out_valid, out_masks


# ---------------------------------------------------------------- optimizer

_NORMS = (nn.LayerNorm, nn.BatchNorm2d)


def no_decay_names(model: nn.Module) -> set:
    """The AdamW no-decay set over the port's mmdet names: every bias, every
    norm's weight and bias, and every relative_position_bias_table. It is
    the set JAX's flax-path rule gives (`detector_param_labels`: 'norm' in
    the path, a last key 'bias' or 'scale', or the table), where the norms
    are the only modules with a 'scale' or 'norm' in their path."""
    names = set()
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            if (p_name == "bias" or isinstance(mod, _NORMS)
                    or p_name == "relative_position_bias_table"):
                names.add(full)
    return names


def detector_lr_schedule(base_lr: float = 1e-4, steps_per_epoch: int = 1000,
                         warmup_iters: int = 500, warmup_ratio: float = 1e-3):
    """step -> learning rate, the reference's schedule: mmcv's linear warmup
    over the first 500 iterations (factor 1 - (1 - step / iters) (1 - ratio),
    so step 0 trains at base_lr * 1e-3) into a step decay x0.1 at epochs 27
    and 33. Computed in float32 as optax computes it."""
    f32 = np.float32
    boundaries = (27 * steps_per_epoch, 33 * steps_per_epoch)

    def sched(step):
        decay = f32(base_lr)
        for b in boundaries:
            if step >= b:
                decay = f32(f32(0.1) * decay)
        frac = min(f32(step) / f32(warmup_iters), f32(1.0))
        factor = f32(1.0) - (f32(1.0) - frac) * f32(1.0 - warmup_ratio)
        return float(f32(decay * factor))

    return sched


def detector_optimizer(model: nn.Module, base_lr: float = 1e-4, weight_decay: float = 0.05,
                       steps_per_epoch: int = 1000, warmup_iters: int = 500,
                       warmup_ratio: float = 1e-3):
    """AdamW (betas 0.9 / 0.999, eps 1e-8) in two groups, weight decay
    `weight_decay` and 0 for `no_decay_names`, under a LambdaLR with
    `detector_lr_schedule`: update k runs at the schedule's step k, as
    optax's count. Returns (optimizer, scheduler); call `scheduler.step()`
    after each `optimizer.step()`."""
    skip = no_decay_names(model)
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (no_decay if name in skip else decay).append(p)
    opt = torch.optim.AdamW([{"params": decay, "weight_decay": weight_decay},
                             {"params": no_decay, "weight_decay": 0.0}],
                            lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    sched = detector_lr_schedule(base_lr, steps_per_epoch, warmup_iters, warmup_ratio)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: sched(k) / base_lr)
