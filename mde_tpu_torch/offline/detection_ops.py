"""Detection primitives, the port of `mde_tpu/offline/detection_ops.py`
(:19-227): anchors, delta decoding, fixed-capacity NMS and RoIAlign.

Shapes stay fixed, as in the JAX package: proposals and detections are
fixed-capacity tensors with validity masks, and nothing here reads a value
back to the host, so a frame runs without a device-to-host sync until its
results are copied out.

- `top_k` is a stable descending sort, so equal scores keep the lower index
  first, as `jax.lax.top_k` (`torch.topk` on CUDA gives no order among ties).
- `nms_fixed` is the JAX scan: `max_out` greedy steps over an (N, N)
  suppression matrix; a padding slot is index 0 with valid False, as
  `argmax` over all `-inf` gives. Each step is three launches (a row
  gather, a masked fill, a max that returns value and index).
- `roi_align` keeps the JAX package's static lattice (`sampling_ratio=0`
  takes 2 x 2 taps a bin, not mmcv's adaptive ceil(bin size); see
  `mde_tpu/offline/detection_ops.py:132-157`). `extract_roi_features`
  samples each roi on its mapped FPN level only (JAX computes every level
  and selects), from one flat (sum of H x W, C) copy of the levels, and
  accumulates the taps one sample at a time, so 1,000 rois of 7 x 7 bins
  and 256 channels hold ~50 MB a tap instead of the (R, P, S, P, S, C)
  lattice. Adds run in a fixed order, so the card and the CPU give the same
  bits. In training the gathers' backward adds into the levels with
  float32 atomics: the gradient's sums run in no fixed order.
"""

import numpy as np
import torch

# -------------------------------------------------------------------- anchors


def base_anchors(stride: int, scales=(8,), ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """mmdet AnchorGenerator base anchors (center offset 0)."""
    w = h = stride
    out = []
    for r in ratios:
        h_r = np.sqrt(r)
        w_r = 1.0 / h_r
        for s in scales:
            ws = w * s * w_r
            hs = h * s * h_r
            out.append([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int,
                 scales=(8,), ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """(feat_h*feat_w*A, 4) anchors for one level, (y, x, anchor) order."""
    base = base_anchors(stride, scales, ratios)
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


# ---------------------------------------------------------------- bbox deltas


def delta2bbox(rois, deltas, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.),
               max_shape=None, wh_ratio_clip=16 / 1000):
    """mmdet DeltaXYWHBBoxCoder.decode, float32."""
    means = torch.tensor(means, dtype=torch.float32, device=deltas.device)
    stds = torch.tensor(stds, dtype=torch.float32, device=deltas.device)
    d = deltas * stds + means
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(float(np.log(wh_ratio_clip)))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1, y1, x2, y2 = gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5
    if max_shape is not None:
        h, w = max_shape
        x1, x2 = x1.clamp(0, w), x2.clamp(0, w)
        y1, y2 = y1.clamp(0, h), y2.clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


# ----------------------------------------------------------------------- NMS


def top_k(scores, k: int):
    """(values, indices) of the k largest, the lower index first among equal
    scores (`jax.lax.top_k`)."""
    values, indices = torch.sort(scores, descending=True, stable=True)
    return values[:k], indices[:k]


def box_iou(boxes1, boxes2):
    """(M, 4) x (N, 4) -> (M, N) IoU."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]).clamp(min=0) * (boxes1[:, 3] - boxes1[:, 1]).clamp(min=0)
    area2 = (boxes2[:, 2] - boxes2[:, 0]).clamp(min=0) * (boxes2[:, 3] - boxes2[:, 1]).clamp(min=0)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms_fixed(boxes, scores, iou_threshold: float, max_out: int):
    """Greedy NMS with static shapes. Returns (keep_idx (max_out,) int64,
    keep_valid (max_out,) bool): the survivors in score order, then padding
    slots (index 0, valid False)."""
    # a row kills what the box suppresses and the box itself (a degenerate
    # box has IoU 0 with itself)
    kill = box_iou(boxes, boxes) > iou_threshold
    kill.fill_diagonal_(True)
    masked = scores.clone()
    values, indices = [], []
    for _ in range(max_out):
        best_val, best = masked.max(dim=0)
        values.append(best_val)
        indices.append(best)
        masked.masked_fill_(kill.index_select(0, best.view(1))[0], float("-inf"))
    return torch.stack(indices), torch.stack(values) > float("-inf")


def batched_nms_fixed(boxes, scores, ids, iou_threshold: float, max_out: int):
    """Class/level-aware NMS: boxes offset per id so that boxes of two ids
    never overlap (mmcv's batched_nms)."""
    max_coord = boxes.max() + 1.0
    offsets = ids.to(torch.float32)[:, None] * max_coord
    return nms_fixed(boxes + offsets, scores, iou_threshold, max_out)


# ------------------------------------------------------------------ RoIAlign


def _sample_axis(coord, size):
    """Per-axis part of mmcv's bilinear_interpolate: whether the sample lies
    in [-1, size], the low and high source indices and the high weight."""
    inside = (coord >= -1.0) & (coord <= size)
    c = coord.clamp(min=0.0)
    c0 = torch.floor(c)
    frac = c - c0
    lo = torch.minimum(torch.clamp(c0.to(torch.int64), min=0), size - 1)
    hi = torch.minimum(lo + 1, size - 1)
    return inside, lo, hi, frac


def _roi_align_flat(flat, offset, height, width, scale, rois, p: int, s: int):
    """RoIAlign of each roi on its own map: `flat` (sum of H x W, C) holds the
    maps row-major, and offset, height, width and scale are per-roi (R,)
    tensors (int64, int64, int64, float32). Returns (R, C, p, p) float32."""
    r = rois.shape[0]
    c = flat.shape[1]
    # training gathers from a float32 copy: the gather's backward is then a
    # float32 index_add (atomic adds), where an accumulating index_put of
    # bf16 sorts its indices first (most of a detector step's device time
    # on an H100); the values gathered are the same
    src = flat.float() if flat.requires_grad else flat
    x1 = rois[:, 0] * scale - 0.5
    y1 = rois[:, 1] * scale - 0.5
    x2 = rois[:, 2] * scale - 0.5
    y2 = rois[:, 3] * scale - 0.5
    # divided by a tensor on the rois' device: CUDA divides by a host scalar
    # as a product with its reciprocal, one rounding off the CPU's quotient
    bins_per_side = torch.tensor(float(p), device=rois.device)
    bin_w = (x2 - x1).clamp(min=1e-6) / bins_per_side
    bin_h = (y2 - y1).clamp(min=1e-6) / bins_per_side
    bins = torch.arange(p, dtype=torch.float32, device=rois.device)
    hh, ww = height[:, None], width[:, None]
    total = None
    for sy in range(s):
        ys = y1[:, None] + (bins + (sy + 0.5) / s)[None, :] * bin_h[:, None]   # (R, P)
        in_y, y_lo, y_hi, wy1 = _sample_axis(ys, hh)
        for sx in range(s):
            xs = x1[:, None] + (bins + (sx + 0.5) / s)[None, :] * bin_w[:, None]
            in_x, x_lo, x_hi, wx1 = _sample_axis(xs, ww)
            # (R, P_y, P_x) weights and flat indices of the four corners
            a, b = (1 - wy1)[:, :, None], wy1[:, :, None]
            cx, dx = (1 - wx1)[:, None, :], wx1[:, None, :]
            row_lo = offset[:, None, None] + y_lo[:, :, None] * ww[:, :, None]
            row_hi = offset[:, None, None] + y_hi[:, :, None] * ww[:, :, None]
            xl, xh = x_lo[:, None, :], x_hi[:, None, :]

            def tap(index, weight):
                rows = src.index_select(0, index.reshape(-1)).float()
                return rows.reshape(r, p, p, c) * weight[..., None]

            val = (tap(row_lo + xl, a * cx) + tap(row_lo + xh, a * dx)
                   + tap(row_hi + xl, b * cx) + tap(row_hi + xh, b * dx))
            val = torch.where((in_y[:, :, None] & in_x[:, None, :])[..., None], val, 0.0)
            total = val if total is None else total + val
    return (total / (s * s)).permute(0, 3, 1, 2)


def _flat_levels(feats):
    """[(1, C, H_l, W_l)] -> ((sum H_l W_l, C), offsets, heights, widths)."""
    flat = torch.cat([f[0].permute(1, 2, 0).reshape(-1, f.shape[1]) for f in feats])
    sizes = [(f.shape[2], f.shape[3]) for f in feats]
    offsets = np.cumsum([0] + [h * w for h, w in sizes[:-1]])
    dev = flat.device
    return (flat, torch.tensor(offsets, device=dev), torch.tensor([h for h, _ in sizes], device=dev),
            torch.tensor([w for _, w in sizes], device=dev))


def roi_align(feat, rois, output_size: int, spatial_scale: float, sampling_ratio: int = 0):
    """mmcv RoIAlign (aligned=True) on one (1, C, H, W) map; rois (R, 4) in
    image coordinates. Returns (R, C, output_size, output_size) float32.
    sampling_ratio 0 is the JAX package's static 2 taps a bin axis."""
    if feat.shape[0] != 1:
        raise ValueError("roi_align expects a single image feature map")
    flat, offset, height, width = _flat_levels([feat])
    zero = torch.zeros(rois.shape[0], dtype=torch.int64, device=rois.device)
    scale = torch.full((rois.shape[0],), spatial_scale, dtype=torch.float32, device=rois.device)
    s = sampling_ratio if sampling_ratio > 0 else 2
    return _roi_align_flat(flat, offset[zero], height[zero], width[zero], scale, rois,
                           output_size, s)


def map_rois_to_fpn_levels(rois, num_levels: int = 4, finest_scale: int = 56):
    """mmdet SingleRoIExtractor.map_roi_levels: floor(log2(sqrt(area) /
    finest_scale + 1e-6)), clamped to [0, num_levels)."""
    scale = torch.sqrt((rois[:, 2] - rois[:, 0]).clamp(min=0) * (rois[:, 3] - rois[:, 1]).clamp(min=0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int64)


def extract_roi_features(fpn_feats, rois, output_size: int, strides=(4, 8, 16, 32)):
    """RoIAlign each roi on its mapped FPN level -> (R, C, P, P) float32."""
    lvl = map_rois_to_fpn_levels(rois, num_levels=len(strides))
    flat, offset, height, width = _flat_levels(fpn_feats[:len(strides)])
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=rois.device)
    return _roi_align_flat(flat, offset[lvl], height[lvl], width[lvl], scales[lvl], rois,
                           output_size, 2)
