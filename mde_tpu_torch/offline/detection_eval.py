"""COCO-style detection mAP, the port's own copy of
`mde_tpu/offline/detection_eval.py` (numpy, unchanged): the capability of the
Swin fork's tools/test.py with mmdet's CocoDataset.evaluate (box and segm
mAP@[.5:.95]). Greedy score-ordered matching per (image, class, IoU
threshold), 101-point interpolated precision, averaged over the COCO IoU
grid; the non-crowd, area-unfiltered case the reference reports. No
pycocotools.
"""

from collections import defaultdict

import numpy as np

IOU_THRS = np.arange(0.5, 1.0, 0.05)


def _iou_matrix(det_boxes, gt_boxes):
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(det_boxes), len(gt_boxes)))
    area_d = np.maximum(det_boxes[:, 2] - det_boxes[:, 0], 0) * \
        np.maximum(det_boxes[:, 3] - det_boxes[:, 1], 0)
    area_g = np.maximum(gt_boxes[:, 2] - gt_boxes[:, 0], 0) * \
        np.maximum(gt_boxes[:, 3] - gt_boxes[:, 1], 0)
    lt = np.maximum(det_boxes[:, None, :2], gt_boxes[None, :, :2])
    rb = np.minimum(det_boxes[:, None, 2:], gt_boxes[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_d[:, None] + area_g[None, :] - inter, 1e-9)


def _mask_iou_matrix(det_masks, gt_masks):
    if len(det_masks) == 0 or len(gt_masks) == 0:
        return np.zeros((len(det_masks), len(gt_masks)))
    d = det_masks.reshape(len(det_masks), -1).astype(bool)
    g = gt_masks.reshape(len(gt_masks), -1).astype(bool)
    inter = d.astype(np.float64) @ g.T.astype(np.float64)
    union = d.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def average_precision(scores, matched, num_gt):
    """101-point interpolated AP from per-detection (score, matched) pairs."""
    if num_gt == 0:
        return np.nan
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(matched, dtype=np.float64)[order]
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # monotone precision envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        p = precision[recall >= r]
        ap += (p[0] if len(p) else 0.0) / 101.0
    return ap


class DetectionEvaluator:
    """Accumulate per-image detections + ground truth; report box/segm mAP.

    add_image(dets, gts): dets = dict(boxes (D,4), scores (D,), labels (D,),
    masks (D,H,W) optional); gts = dict(boxes (G,4), labels (G,),
    masks (G,H,W) optional).
    """

    def __init__(self, num_classes: int, with_masks: bool = False):
        self.num_classes = num_classes
        self.with_masks = with_masks
        # per (class, iou_idx): list of (score, matched)
        self._records = defaultdict(list)
        self._mask_records = defaultdict(list)
        self._num_gt = np.zeros(num_classes, np.int64)

    def add_image(self, dets, gts):
        det_boxes = np.asarray(dets.get("boxes", np.zeros((0, 4))), np.float64)
        det_scores = np.asarray(dets.get("scores", np.zeros((0,))), np.float64)
        det_labels = np.asarray(dets.get("labels", np.zeros((0,))), np.int64)
        gt_boxes = np.asarray(gts.get("boxes", np.zeros((0, 4))), np.float64)
        gt_labels = np.asarray(gts.get("labels", np.zeros((0,))), np.int64)

        for c in np.unique(np.concatenate([det_labels, gt_labels])).astype(int):
            d_idx = np.flatnonzero(det_labels == c)
            g_idx = np.flatnonzero(gt_labels == c)
            self._num_gt[c] += len(g_idx)
            order = d_idx[np.argsort(-det_scores[d_idx])]
            iou = _iou_matrix(det_boxes[order], gt_boxes[g_idx])
            self._match(iou, det_scores[order], c, self._records)
            if self.with_masks and "masks" in dets and "masks" in gts:
                miou = _mask_iou_matrix(np.asarray(dets["masks"])[order],
                                        np.asarray(gts["masks"])[g_idx])
                self._match(miou, det_scores[order], c, self._mask_records)

    def _match(self, iou, scores, c, records):
        for t_i, thr in enumerate(IOU_THRS):
            taken = np.zeros(iou.shape[1], bool)
            for i in range(iou.shape[0]):
                best, best_g = thr, -1
                for g in range(iou.shape[1]):
                    if not taken[g] and iou[i, g] >= best:
                        best, best_g = iou[i, g], g
                matched = best_g >= 0
                if matched:
                    taken[best_g] = True
                records[(c, t_i)].append((scores[i], matched))

    def _summarize(self, records):
        aps = []
        ap50 = []
        for c in range(self.num_classes):
            if self._num_gt[c] == 0:
                continue
            per_thr = []
            for t_i in range(len(IOU_THRS)):
                recs = records.get((c, t_i), [])
                scores = [r[0] for r in recs]
                matched = [r[1] for r in recs]
                per_thr.append(average_precision(scores, matched, self._num_gt[c]))
            aps.append(np.nanmean(per_thr))
            ap50.append(per_thr[0])
        if not aps:
            return {"mAP": float("nan"), "mAP50": float("nan")}
        return {"mAP": float(np.mean(aps)), "mAP50": float(np.mean(ap50))}

    def summarize(self):
        out = {f"bbox_{k}": v for k, v in self._summarize(self._records).items()}
        if self.with_masks:
            out.update({f"segm_{k}": v
                        for k, v in self._summarize(self._mask_records).items()})
        return out
