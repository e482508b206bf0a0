"""Cascade Mask R-CNN, the port of `mde_tpu/offline/cascade_rcnn.py` (:39-348):
inference, Swin-B -> FPN(5) -> RPN (3 anchors a location, top
1,000 a level, NMS 0.7, 1,000 proposals) -> 3 cascade ConvFC bbox heads
(class scores averaged over the stages, boxes refined by the argmax class's
deltas) -> class-aware NMS (score threshold, IoU 0.5, 100 detections) -> 3 FCN
mask heads (28 x 28 sigmoid masks averaged over the stages); and
`compute_losses`, the multi-stage training loss of one image (the RPN's,
then each stage's classification, GIoU and mask losses on its sampled rois,
the proposals and each stage's refined rois carrying no gradient).

Names are mmdet's (`backbone.*`, `neck.*`, `rpn_head.{rpn_conv, rpn_cls,
rpn_reg}`, `roi_head.bbox_head.{i}.{shared_convs.{j}.{conv, bn}, shared_fcs.0,
fc_cls, fc_reg}`, `roi_head.mask_head.{i}.{convs.{j}.conv, upsample,
conv_logits}`), so `load_detector` reads an mmdet checkpoint with no
conversion. As in mmdet, the bbox heads flatten their (C, 7, 7) roi
features channel first, and the mask upsample is torch's ConvTranspose2d.
(`mde_tpu/offline/swin_convert.py` maps both without reordering: see
ROADMAP §3.)

Casts follow the JAX module: the RPN scores and deltas, the heads' outputs
and every box in float32; the bbox heads' BatchNorm in float32; RoIAlign
samples bf16 maps in float32. Every capacity is fixed; `infer` reads
nothing back to the host.

`paste_masks` and `collapse_detections` are the host functions of the
JAX module, in numpy, unchanged.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import _linear_weights_half_pixel
from .detection_ops import (batched_nms_fixed, delta2bbox, extract_roi_features,
                            grid_anchors, top_k)
from .fpn import FPN
from .layers import BatchNorm2d, compute_dtype, load_checked, to_compute_dtype
from .swin import SwinTransformer, relative_position_index, resize_rel_pos_table

STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
FPN_STRIDES = (4, 8, 16, 32, 64)
NUM_PROPOSALS = 1000
MAX_DETS = 100


class RPNHead(nn.Module):
    """3x3 conv + objectness / delta 1x1 heads, shared across levels."""

    def __init__(self, channels=256, num_anchors=3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            y = F.relu(self.rpn_conv(f))
            outs.append((self.rpn_cls(y), self.rpn_reg(y)))
        return outs


class _ConvBN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(c)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _Conv(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv(x))


class ConvFCBBoxHead(nn.Module):
    """4 shared convs (+BN) + 1 shared fc -> cls (C+1) and class-specific
    reg (4C), both float32."""

    def __init__(self, num_classes=100, channels=256, roi=7):
        super().__init__()
        self.shared_convs = nn.ModuleList(_ConvBN(channels) for _ in range(4))
        self.shared_fcs = nn.ModuleList([nn.Linear(channels * roi * roi, 1024)])
        self.fc_cls = nn.Linear(1024, num_classes + 1)
        self.fc_reg = nn.Linear(1024, num_classes * 4)

    def forward(self, roi_feats):
        y = roi_feats.to(compute_dtype(self.fc_cls))
        for conv in self.shared_convs:
            y = conv(y)
        y = F.relu(self.shared_fcs[0](y.flatten(1)))
        return self.fc_cls(y).float(), self.fc_reg(y).float()


class FCNMaskHead(nn.Module):
    """4 convs + 2x2 stride-2 transposed conv + 1x1 -> (R, C, 28, 28) float32."""

    def __init__(self, num_classes=100, channels=256):
        super().__init__()
        self.convs = nn.ModuleList(_Conv(channels) for _ in range(4))
        self.upsample = nn.ConvTranspose2d(channels, channels, 2, 2)
        self.conv_logits = nn.Conv2d(channels, num_classes, 1)

    def forward(self, roi_feats):
        y = roi_feats.to(compute_dtype(self.conv_logits))
        for conv in self.convs:
            y = conv(y)
        return self.conv_logits(F.relu(self.upsample(y))).float()


class CascadeRoIHead(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.bbox_head = nn.ModuleList(ConvFCBBoxHead(num_classes) for _ in range(3))
        self.mask_head = nn.ModuleList(FCNMaskHead(num_classes) for _ in range(3))


class CascadeMaskRCNN(nn.Module):
    """The detector; `infer` returns the fixed-size detections of one frame."""

    def __init__(self, num_classes=100, score_thr=0.05, depths=(2, 2, 18, 2),
                 use_checkpoint=False):
        super().__init__()
        self.num_classes = num_classes
        # test_cfg.rcnn score threshold (mmdet's 0.05); random-init runs lower
        # it: an untrained head's softmax sits near 1/(C+1)
        self.score_thr = score_thr
        # use_checkpoint recomputes each Swin block in the backward (training memory)
        self.backbone = SwinTransformer(depths=depths, use_checkpoint=use_checkpoint)
        self.neck = FPN()
        self.rpn_head = RPNHead()
        self.roi_head = CascadeRoIHead(num_classes)
        self._anchors = {}

    def features(self, image):
        """(1, 3, H, W) padded image -> five FPN maps."""
        return self.neck(self.backbone(image))

    def anchors(self, fh, fw, level, device):
        """One level's anchors on `device`, made once (outside inference mode,
        so that training after inference can use them)."""
        key = (fh, fw, level, str(device))
        if key not in self._anchors:
            with torch.inference_mode(False):
                self._anchors[key] = torch.from_numpy(
                    grid_anchors(fh, fw, FPN_STRIDES[level])).to(device)
        return self._anchors[key]

    def proposals(self, feats, img_hw, rpn_outs=None):
        """RPN head (unless its outputs are given), top 1,000 a level and
        level-aware NMS (test_cfg.rpn: nms_pre 1000, IoU 0.7, max 1000) ->
        (boxes (1000, 4), valid (1000,))."""
        all_boxes, all_scores, all_ids = [], [], []
        rpn_outs = self.rpn_head(feats) if rpn_outs is None else rpn_outs
        for lvl, ((cls, reg), f) in enumerate(zip(rpn_outs, feats)):
            fh, fw = f.shape[-2:]
            scores = torch.sigmoid(cls.permute(0, 2, 3, 1).reshape(-1).float())
            deltas = reg.permute(0, 2, 3, 1).reshape(-1, 4).float()
            k = min(NUM_PROPOSALS, scores.shape[0])
            top_s, top_i = top_k(scores, k)
            all_boxes.append(delta2bbox(self.anchors(fh, fw, lvl, f.device)[top_i],
                                        deltas[top_i], max_shape=img_hw))
            all_scores.append(top_s)
            all_ids.append(torch.full((k,), lvl, dtype=torch.int64, device=f.device))
        boxes = torch.cat(all_boxes)
        keep, valid = batched_nms_fixed(boxes, torch.cat(all_scores), torch.cat(all_ids),
                                        0.7, NUM_PROPOSALS)
        return boxes[keep], valid

    def cascade(self, feats, rois, img_hw):
        """Three bbox stages: returns the refined rois and the class
        probabilities averaged over the stages (R, C+1)."""
        cls_sum = None
        arange = torch.arange(rois.shape[0], device=rois.device)
        for i, head in enumerate(self.roi_head.bbox_head):
            cls_score, bbox_pred = head(extract_roi_features(feats[:4], rois, 7))
            probs = torch.softmax(cls_score, dim=-1)
            cls_sum = probs if cls_sum is None else cls_sum + probs
            # refine with the argmax class's deltas (mmdet regress_by_class)
            best = torch.argmax(cls_score[:, :-1], dim=-1)
            sel = bbox_pred.reshape(-1, self.num_classes, 4)[arange, best]
            rois = delta2bbox(rois, sel, stds=STAGE_STDS[i], max_shape=img_hw)
        return rois, cls_sum / 3.0

    def multiclass_nms(self, rois, cls_avg, prop_valid):
        """mmdet multiclass_nms with fixed capacity (test_cfg.rcnn: score
        threshold, IoU 0.5, 100 detections)."""
        c = self.num_classes
        scores = torch.where(prop_valid[:, None], cls_avg[:, :-1], 0.0).reshape(-1)
        scores = torch.where(scores > self.score_thr, scores, 0.0)
        top_s, top_i = top_k(scores, min(NUM_PROPOSALS, scores.shape[0]))
        cand_boxes = rois[top_i // c]
        cand_labels = top_i % c
        keep, keep_valid = batched_nms_fixed(cand_boxes, top_s, cand_labels, 0.5, MAX_DETS)
        out_scores = top_s[keep]
        return (cand_boxes[keep], out_scores, cand_labels[keep],
                keep_valid & (out_scores > self.score_thr))

    def masks(self, feats, boxes, labels):
        """(D, 28, 28) sigmoid masks of the detected class, averaged over the
        three mask heads."""
        roi_feats = extract_roi_features(feats[:4], boxes, 14)
        prob = None
        for head in self.roi_head.mask_head:
            p = torch.sigmoid(head(roi_feats))
            prob = p if prob is None else prob + p
        prob = prob / 3.0
        return prob[torch.arange(labels.shape[0], device=labels.device), labels]

    def infer(self, image, img_hw):
        """Detect on one padded (1, 3, H, W) image; img_hw is the valid
        extent for clipping. Returns fixed-size tensors: boxes (100, 4),
        scores (100,), labels (100,), valid (100,) and masks28 (100, 28, 28)."""
        feats = self.features(image)
        proposals, prop_valid = self.proposals(feats, img_hw)
        rois, cls_avg = self.cascade(feats, proposals, img_hw)
        boxes, scores, labels, valid = self.multiclass_nms(rois, cls_avg, prop_valid)
        return {"boxes": boxes, "scores": scores, "labels": labels, "valid": valid,
                "masks28": self.masks(feats, boxes, labels)}

    def compute_losses(self, image, gt_boxes, gt_labels, gt_valid, gt_masks, uniform, img_hw,
                       num_samples: int = 512):
        """Single-image multi-stage training losses (mmdet CascadeRoIHead
        forward_train; the reference's train_cfg), `mde_tpu/offline/
        cascade_rcnn.py:174-243`. The module is in training mode, so the bbox
        heads' BatchNorms take the stats of the sampled rois.

        image (1, 3, H, W); gt_boxes (G, 4), gt_labels (G,), gt_valid (G,)
        padded to a static G; gt_masks (G, H', W') uint8 or float, H' <= H and
        W' <= W; `uniform(n)` gives the sampler's draws
        (`detection_train.py`). Returns a dict of scalar float32 losses and
        their sum, "total"."""
        from .detection_train import (STAGE_LOSS_WEIGHTS, STAGE_POS_THR, mask_loss,
                                      mask_targets, rcnn_stage_loss, rcnn_stage_targets,
                                      rpn_loss)

        feats = self.features(image)
        rpn_outs = self.rpn_head(feats)
        dev = image.device
        anchors = torch.cat([self.anchors(f.shape[-2], f.shape[-1], lvl, dev)
                             for lvl, f in enumerate(feats)])
        cls_flat = torch.cat([c.permute(0, 2, 3, 1).reshape(-1) for c, _ in rpn_outs]).float()
        reg_flat = torch.cat([r.permute(0, 2, 3, 1).reshape(-1, 4) for _, r in rpn_outs]).float()
        rpn_cls, rpn_reg = rpn_loss(anchors, cls_flat, reg_flat, gt_boxes, gt_labels, gt_valid,
                                    uniform, img_hw)
        losses = {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg}
        # no gradient through the proposal chain (JAX's stop_gradient), and
        # no autograd record of its NMS loop
        with torch.no_grad():
            rois = self.proposals(feats, img_hw, rpn_outs)[0]
        c = self.num_classes
        for i, (head, mask_head) in enumerate(zip(self.roi_head.bbox_head,
                                                  self.roi_head.mask_head)):
            tgt = rcnn_stage_targets(uniform, rois, gt_boxes, gt_labels, gt_valid,
                                     STAGE_POS_THR[i], c, num_samples, add_gt=True)
            cls_score, bbox_pred = head(extract_roi_features(feats[:4], tgt["rois"], 7))
            deltas = bbox_pred.reshape(-1, c, 4)
            arange = torch.arange(deltas.shape[0], device=dev)
            # the target class's deltas, decoded for the GIoU loss
            decoded = delta2bbox(tgt["rois"], deltas[arange, tgt["labels"].clamp(max=c - 1)],
                                 stds=STAGE_STDS[i], max_shape=img_hw)
            cls_l, reg_l = rcnn_stage_loss(cls_score, decoded, tgt, c)
            w = STAGE_LOSS_WEIGHTS[i]
            losses[f"s{i}_cls"] = w * cls_l
            losses[f"s{i}_reg"] = w * reg_l
            m_logits = mask_head(extract_roi_features(feats[:4], tgt["rois"], 14))
            losses[f"s{i}_mask"] = w * mask_loss(m_logits, tgt, mask_targets(gt_masks, tgt))
            # the next stage's rois: refined by the predicted class's deltas
            best = torch.argmax(cls_score[:, :-1], dim=-1)
            rois = delta2bbox(tgt["rois"], deltas[arange, best], stds=STAGE_STDS[i],
                              max_shape=img_hw).detach()
        losses["total"] = sum(losses.values())
        return losses


def load_detector(ckpt_path: str, window_size=None, dtype=torch.float32, num_classes=None,
                  score_thr=0.05, depths=(2, 2, 18, 2)) -> CascadeMaskRCNN:
    """An mmdet checkpoint (`{"state_dict": ...}`) into CascadeMaskRCNN on the
    CPU, in eval mode. A missing or unexpected key raises, named. The checkpoint's
    `relative_position_index` buffers must equal the index this model builds;
    with `window_size`, position-bias tables of another window are resized
    bicubically first (the fork's loader)."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = dict(ckpt.get("state_dict", ckpt.get("model", ckpt)))
    if num_classes is None:
        num_classes = sd["roi_head.bbox_head.0.fc_cls.weight"].shape[0] - 1
    with torch.device("meta"):
        model = CascadeMaskRCNN(num_classes, score_thr, depths)
    if window_size is not None:
        target = (2 * window_size - 1) ** 2
        for k in [k for k in sd if k.endswith("attn.relative_position_bias_table")]:
            if sd[k].shape[0] != target:
                sd[k] = torch.from_numpy(resize_rel_pos_table(sd[k].numpy(), target))
    index = torch.from_numpy(relative_position_index(model.backbone.window_size).reshape(-1))
    for k in [k for k in sd if k.endswith("attn.relative_position_index")]:
        if not torch.equal(sd.pop(k).reshape(-1).long(), index):
            raise ValueError(f"{ckpt_path}: {k} is not the index of window "
                             f"{model.backbone.window_size}")
    load_checked(model, sd, ckpt_path)
    return to_compute_dtype(model, dtype).eval()


# ------------------------------------------------------------------ host side


def paste_masks(det: dict, img_h: int, img_w: int, thr: float = 0.5) -> np.ndarray:
    """Resize each valid 28x28 mask into its box and threshold (mmdet
    FCNMaskHead.get_seg_masks semantics); (D, img_h, img_w) bool."""
    boxes = np.asarray(det["boxes"])
    masks28 = np.asarray(det["masks28"])
    valid = np.asarray(det["valid"])
    out = np.zeros((boxes.shape[0], img_h, img_w), dtype=bool)
    for i in range(boxes.shape[0]):
        if not valid[i]:
            continue
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        w = max(x2i - x1i, 1)
        h = max(y2i - y1i, 1)
        m = _linear_weights_half_pixel(28, h) @ masks28[i] @ _linear_weights_half_pixel(28, w).T
        ys, ye = max(y1i, 0), min(y2i, img_h)
        xs, xe = max(x1i, 0), min(x2i, img_w)
        if ys >= ye or xs >= xe:
            continue
        out[i, ys:ye, xs:xe] = m[ys - y1i:ye - y1i, xs - x1i:xe - x1i] > thr
    return out


def collapse_detections(det: dict, masks_full: np.ndarray, img_h: int, img_w: int,
                        use_bbox_area: bool = False):
    """The reference's collapse (tools/nyud2_inference.py:104-124): detections
    painted in ascending class order (score order within a class), later
    classes over earlier ones. Returns (labels int32, background -1; areas
    int32: the mask's pixel count or the box's area)."""
    labels = np.asarray(det["labels"])
    boxes = np.asarray(det["boxes"])
    valid = np.asarray(det["valid"])
    collapsed_labels = np.full((img_h, img_w), -1, dtype=np.int32)
    collapsed_areas = np.zeros((img_h, img_w), dtype=np.int32)
    for i in np.argsort(labels, kind="stable"):
        if not valid[i]:
            continue
        m = masks_full[i]
        if use_bbox_area:
            x1, y1, x2, y2 = boxes[i]
            area = int((x2 - x1) * (y2 - y1))
        else:
            area = int(m.sum())
        collapsed_labels[m] = int(labels[i])
        collapsed_areas[m] = area
    return collapsed_labels, collapsed_areas
