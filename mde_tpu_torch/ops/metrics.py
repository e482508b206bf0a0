"""Depth-eval metrics, port of `mde_tpu/ops/metrics.py` (reference
utils.py:119-139): the host version over gathered valid pixels, a masked
version on the device, the static eval crop, and the segmentation mIoU
accumulators (`intersection_and_union`, numpy).

Every metric is a mean over valid pixels, so the masked form (weighted means
over the dense map) is the same arithmetic as the gathered form with shapes
that do not depend on the data.
"""

import numpy as np
import torch

METRIC_NAMES = ("a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel")


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> dict:
    """Host/numpy metrics on pre-gathered valid pixels (1-D arrays)."""
    thresh = np.maximum((gt / pred), (pred / gt))
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()

    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())

    err = np.log(pred) - np.log(gt)
    silog = np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2) * 100

    log_10 = (np.abs(np.log10(gt) - np.log10(pred))).mean()
    return dict(a1=a1, a2=a2, a3=a3, abs_rel=abs_rel, rmse=rmse, log_10=log_10,
                rmse_log=rmse_log, silog=silog, sq_rel=sq_rel)


def compute_errors_masked(gt: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor,
                          dim=None) -> dict:
    """Device metrics over a dense map and a boolean validity mask: the
    arithmetic of `compute_errors` restricted to mask == True, in float32.
    Means are taken over `dim` (all dimensions by default), so (N, H, W)
    inputs with dim=(-2, -1) give one value per image."""
    gt = gt.float()
    pred = pred.float()
    dims = tuple(range(gt.dim())) if dim is None else dim
    n = torch.clamp(mask.float().sum(dims), min=1.0)

    def mmean(x):
        return torch.where(mask, x, 0.0).sum(dims) / n

    safe_gt = torch.where(mask, gt, 1.0)
    safe_pred = torch.where(mask, pred, 1.0)

    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    a1 = mmean((thresh < 1.25).float())
    a2 = mmean((thresh < 1.25 ** 2).float())
    a3 = mmean((thresh < 1.25 ** 3).float())

    abs_rel = mmean(torch.abs(safe_gt - safe_pred) / safe_gt)
    sq_rel = mmean((safe_gt - safe_pred) ** 2 / safe_gt)
    rmse = torch.sqrt(mmean((safe_gt - safe_pred) ** 2))

    lg, lp = torch.log(safe_gt), torch.log(safe_pred)
    rmse_log = torch.sqrt(mmean((lg - lp) ** 2))
    err = lp - lg
    silog = torch.sqrt(torch.clamp(mmean(err ** 2) - mmean(err) ** 2, min=0.0)) * 100.0
    log_10 = mmean(torch.abs(torch.log10(safe_gt) - torch.log10(safe_pred)))

    return dict(a1=a1, a2=a2, a3=a3, abs_rel=abs_rel, rmse=rmse, log_10=log_10,
                rmse_log=rmse_log, silog=silog, sq_rel=sq_rel)


def intersection_and_union(pred: np.ndarray, label: np.ndarray, num_classes: int,
                           ignore_index: int = -1):
    """Segmentation mIoU accumulators (the reference's mit_semseg/utils.py
    intersectionAndUnion): per-class (intersection, union) histograms;
    mIoU = (inter / union).mean() over the classes with union > 0."""
    pred = np.asarray(pred).reshape(-1)
    label = np.asarray(label).reshape(-1)
    valid = label != ignore_index
    pred = pred[valid]
    label = label[valid]
    inter = pred[pred == label]
    area_inter, _ = np.histogram(inter, bins=num_classes, range=(0, num_classes))
    area_pred, _ = np.histogram(pred, bins=num_classes, range=(0, num_classes))
    area_label, _ = np.histogram(label, bins=num_classes, range=(0, num_classes))
    return area_inter, area_pred + area_label - area_inter


def eval_mask(gt_hw_shape, dataset: str = "nyu", garg_crop: bool = False,
              eigen_crop: bool = True) -> np.ndarray:
    """Static eval crop mask (reference evaluate.py:136-150)."""
    gt_height, gt_width = gt_hw_shape
    mask = np.zeros((gt_height, gt_width), dtype=bool)
    if garg_crop:
        mask[int(0.40810811 * gt_height):int(0.99189189 * gt_height),
             int(0.03594771 * gt_width):int(0.96405229 * gt_width)] = True
    elif eigen_crop:
        if dataset == 'kitti':
            mask[int(0.3324324 * gt_height):int(0.91351351 * gt_height),
                 int(0.0359477 * gt_width):int(0.96405229 * gt_width)] = True
        else:
            mask[45:471, 41:601] = True
    else:
        mask[:] = True
    return mask
