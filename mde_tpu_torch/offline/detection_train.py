"""Detector training machinery, the port of `mde_tpu/offline/detection_train.py`
(:1-276): target coders, losses, assignment, sampling and the per-stage
targets of the Swin-B Cascade Mask R-CNN (mmdet's MaxIoUAssigner,
RandomSampler, DeltaXYWHBBoxCoder, SmoothL1 / GIoU / CE / BCE losses).

Everything keeps a fixed shape and stays on the device: assignment is a
dense IoU argmax, sampling a top-k over uniform scores with validity masks,
and each loss divides by a count held as a tensor, so a training step reads
nothing back to the host.

The sampler's uniforms come from `uniform(n)`, a callable that returns an
(n,) float32 tensor in [0, 1) on the assignment's device. `compute_losses`
calls it eight times a step, in JAX's key order (`cascade_rcnn.py:197,
:207`, `random_sample` :141): the RPN's positives and negatives, then each
stage's. `generator_uniform` draws them from a `torch.Generator`; a test hands
it JAX's own draws instead. Ties among scores keep the lower index first
(`detection_ops.top_k`, a stable sort, as `jax.lax.top_k`), and the slots
are compacted with a stable argsort, as `jnp.argsort(~valid)`: with
BatchNorm in the bbox heads taking stats over every sampled roi, which of the
tied invalid rois fill the slots changes the step.

Train config (the reference's): RPN MaxIoUAssigner(0.7 / 0.3 / min_pos 0.3,
match_low_quality), RandomSampler(256, pos 0.5), SmoothL1(beta 1/9); RCNN
stages pos/neg thresholds 0.5/0.6/0.7, RandomSampler(512, pos 0.25,
add_gt_as_proposals), CE + 10 x GIoU on decoded boxes, mask BCE at 28x28,
stage loss weights 1/0.5/0.25.
"""

from typing import NamedTuple

import torch

from .detection_ops import _roi_align_flat, box_iou, top_k

STAGE_POS_THR = (0.5, 0.6, 0.7)
STAGE_LOSS_WEIGHTS = (1.0, 0.5, 0.25)


def generator_uniform(generator: torch.Generator):
    """`uniform(n)` drawing from `generator` on the generator's device."""
    return lambda n: torch.rand(n, generator=generator, device=generator.device)


# ------------------------------------------------------------------- coders


def bbox2delta(proposals, gt, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.)):
    """mmdet DeltaXYWHBBoxCoder.encode."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=1e-6)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=1e-6)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw),
                          torch.log(gh / ph)], dim=-1)
    dev = deltas.device
    return ((deltas - torch.tensor(means, dtype=torch.float32, device=dev))
            / torch.tensor(stds, dtype=torch.float32, device=dev))


# ------------------------------------------------------------------- losses


def smooth_l1_loss(pred, target, beta: float = 1.0):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def giou(boxes1, boxes2):
    """Elementwise GIoU between aligned box arrays (..., 4)."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]).clamp(min=0) * \
        (boxes1[..., 3] - boxes1[..., 1]).clamp(min=0)
    area2 = (boxes2[..., 2] - boxes2[..., 0]).clamp(min=0) * \
        (boxes2[..., 3] - boxes2[..., 1]).clamp(min=0)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area1 + area2 - inter).clamp(min=1e-7)
    iou = inter / union
    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_c = (rb_c - lt_c).clamp(min=0)
    enclose = (wh_c[..., 0] * wh_c[..., 1]).clamp(min=1e-7)
    return iou - (enclose - union) / enclose


def giou_loss(pred_boxes, target_boxes):
    return 1.0 - giou(pred_boxes, target_boxes)


def softmax_ce_loss(logits, labels):
    """Per-sample cross entropy with integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def bce_with_logits(logits, targets):
    """Stable elementwise BCE with logits."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _mean_over(values, mask, count_mask):
    """sum(values where mask) / max(count of count_mask, 1), on the device."""
    return (torch.where(mask, values, 0.0).sum()
            / count_mask.sum().clamp(min=1).to(values.dtype))


# -------------------------------------------------------------- assignment


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor   # (N,) -1 negative, -2 ignored, >= 0 the GT index
    max_ious: torch.Tensor  # (N,)
    labels: torch.Tensor    # (N,) the assigned GT's class (0 where not positive)


def max_iou_assign(boxes, gt_boxes, gt_labels, gt_valid, pos_iou_thr: float,
                   neg_iou_thr: float, min_pos_iou: float,
                   match_low_quality: bool) -> AssignResult:
    """mmdet MaxIoUAssigner with static shapes; gt_valid masks padded GTs."""
    iou = torch.where(gt_valid[None, :], box_iou(boxes, gt_boxes), -1.0)    # (N, G)
    max_iou, argmax = iou.max(dim=1)
    gt_inds = torch.full_like(argmax, -2)
    gt_inds = torch.where(max_iou >= 0, -1, gt_inds)                       # negatives
    gt_inds = torch.where(max_iou >= pos_iou_thr, argmax, gt_inds)
    # [neg_thr, pos_thr) stays ignored (-2), as mmdet
    gt_inds = torch.where((max_iou >= neg_iou_thr) & (max_iou < pos_iou_thr), -2, gt_inds)
    if match_low_quality:
        # each GT claims the boxes of its best overlap if it is >= min_pos_iou
        gt_max = iou.max(dim=0).values
        is_best = (iou == gt_max[None, :]) & (iou >= min_pos_iou) & gt_valid[None, :]
        claimed = torch.argmax(is_best.to(torch.int32), dim=1)               # first True
        gt_inds = torch.where(is_best.any(dim=1), claimed, gt_inds)
    labels = torch.where(gt_inds >= 0, gt_labels[gt_inds.clamp(min=0)], 0)
    return AssignResult(gt_inds, max_iou, labels)


def random_sample(uniform, assign: AssignResult, num: int, pos_fraction: float):
    """mmdet RandomSampler with the static output size `num`. Returns
    (indices (num,), is_pos (num,), valid (num,)): positives first (up to
    num * pos_fraction), negatives filling the rest."""
    n = assign.gt_inds.shape[0]
    num_pos_max = int(num * pos_fraction)
    pos_scores = torch.where(assign.gt_inds >= 0, uniform(n), -1.0)
    neg_scores = torch.where(assign.gt_inds == -1, uniform(n), -1.0)
    pos_top, pos_idx = top_k(pos_scores, min(num_pos_max, n))
    pos_valid = pos_top > 0
    neg_top, neg_idx = top_k(neg_scores, min(num, n))
    # enough negatives to fill `num`
    neg_rank = torch.arange(neg_idx.shape[0], device=neg_idx.device)
    neg_valid = (neg_top > 0) & (neg_rank < num - pos_valid.sum())
    cut = num + num_pos_max
    idx = torch.cat([pos_idx, neg_idx])[:cut]
    is_pos = torch.cat([pos_valid, torch.zeros_like(neg_valid)])[:cut]
    valid = torch.cat([pos_valid, neg_valid])[:cut]
    # compact to `num` slots, the valid ones first in their order
    take = torch.argsort((~valid).to(torch.int8), stable=True)[:num]
    return idx[take], is_pos[take], valid[take]


# -------------------------------------------------------------- rpn targets


def rpn_loss(anchors, cls_logits_flat, deltas_flat, gt_boxes, gt_labels, gt_valid,
             uniform, img_hw, num_samples: int = 256):
    """RPN objectness + box loss for one image (the reference's train_cfg.rpn)."""
    assign = max_iou_assign(anchors, gt_boxes, torch.zeros_like(gt_labels), gt_valid,
                            pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                            match_low_quality=True)
    # allowed_border 0: anchors outside the image are ignored
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] <= img_hw[1]) & (anchors[:, 3] <= img_hw[0]))
    assign = assign._replace(gt_inds=torch.where(inside, assign.gt_inds, -2))
    idx, is_pos, valid = random_sample(uniform, assign, num_samples, 0.5)
    cls_loss = _mean_over(bce_with_logits(cls_logits_flat[idx], is_pos.float()), valid, valid)
    matched = gt_boxes[assign.gt_inds[idx].clamp(min=0)]
    reg = smooth_l1_loss(deltas_flat[idx], bbox2delta(anchors[idx], matched),
                         beta=1.0 / 9.0).sum(-1)
    return cls_loss, _mean_over(reg, valid & is_pos, valid)


# ------------------------------------------------------------- rcnn targets


def rcnn_stage_targets(uniform, proposals, gt_boxes, gt_labels, gt_valid, pos_thr: float,
                       num_classes: int, num_samples: int = 512, add_gt: bool = True):
    """Sample rois and build one stage's class and box targets: dict(rois,
    labels (num,), is_pos, valid, matched_gt, gt_idx). The background label is
    num_classes (mmdet: C + 1 scores, background last)."""
    if add_gt:
        proposals = torch.cat([proposals, gt_boxes])
    assign = max_iou_assign(proposals, gt_boxes, gt_labels, gt_valid, pos_iou_thr=pos_thr,
                            neg_iou_thr=pos_thr, min_pos_iou=pos_thr, match_low_quality=False)
    idx, is_pos, valid = random_sample(uniform, assign, num_samples, 0.25)
    gt_idx = assign.gt_inds[idx].clamp(min=0)
    return dict(rois=proposals[idx],
                labels=torch.where(is_pos, assign.labels[idx], num_classes),
                is_pos=is_pos, valid=valid, matched_gt=gt_boxes[gt_idx], gt_idx=gt_idx)


def rcnn_stage_loss(cls_logits, decoded_boxes, targets, num_classes: int,
                    giou_weight: float = 10.0):
    """CE classification + GIoU regression on decoded boxes
    (reg_decoded_bbox=True in the ade20k config)."""
    valid = targets["valid"]
    is_pos = targets["is_pos"] & valid
    cls_loss = _mean_over(softmax_ce_loss(cls_logits, targets["labels"]), valid, valid)
    reg = giou_loss(decoded_boxes, targets["matched_gt"])
    return cls_loss, giou_weight * _mean_over(reg, is_pos, valid)


def mask_targets(gt_masks, targets, mask_size: int = 28, sampling_ratio: int = 4):
    """Each sampled roi's 28x28 mask-head target: its matched GT bitmap
    sampled by RoIAlign (aligned, a static 4 x 4 lattice a bin) and
    binarised at 0.5 (see `mde_tpu/offline/detection_train.py:234-264`).

    gt_masks: (G, H, W), uint8 or float; each roi's lattice is sampled from
    the GT it matches through a flat index, so no (num, H, W) copy is made.
    Returns (num, 28, 28) float32 in {0, 1}."""
    g, h, w = gt_masks.shape
    rois = targets["rois"]
    r = rois.shape[0]
    dev = rois.device
    size = torch.full((r,), 1, dtype=torch.int64, device=dev)
    vals = _roi_align_flat(gt_masks.reshape(g * h * w, 1), targets["gt_idx"] * (h * w),
                           size * h, size * w, torch.ones(r, device=dev), rois, mask_size,
                           sampling_ratio)
    return (vals[:, 0] >= 0.5).float()


def mask_loss(mask_logits, targets, mask_tgts):
    """BCE on the positive rois' own-class mask maps (mmdet
    FCNMaskHead.loss); mask_logits (R, C, 28, 28)."""
    labels = targets["labels"].clamp(max=mask_logits.shape[1] - 1)
    own = mask_logits[torch.arange(labels.shape[0], device=labels.device), labels]
    per_roi = bce_with_logits(own, mask_tgts).mean(dim=(1, 2))
    is_pos = targets["is_pos"] & targets["valid"]
    return _mean_over(per_roi, is_pos, is_pos)
