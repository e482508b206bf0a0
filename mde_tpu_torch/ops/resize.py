"""Spatial resizes, port of `mde_tpu/ops/resize.py` (NCHW).

The JAX package writes torch's interpolation semantics as separable matmuls;
here they are torch's own: bilinear with align_corners=True (decoder upsample,
flip-TTA resize) and the legacy 'nearest' (cue downsampling).

torch computes the bilinear taps in the input's precision: in float32 the
source coordinate (in-1)/(out-1)*i is off by up to ~2e-5 pixel at 640 px,
which moves outputs by as much times the local step. The JAX package builds
its taps in float64, so a float32 input is resized in float64 here and
rounded back: the two then agree to float32 rounding.

`resize_bilinear_half_pixel` is the JAX package's half-pixel (align_corners
=False) resize (`mde_tpu/ops/resize.py:141-172`), which only the offline
HRNet and `paste_masks` use: the same separable matmul over the same taps
(`_linear_weights_half_pixel`, float64 rounded to float32), float32 inputs
in float64 and bfloat16 ones in float32, then rounded back. `F.interpolate`
is not used: its float32 taps are off by up to ~2e-5 px.

`resize_bilinear_align_corners_np` is the port's copy of the JAX package's
host-side resize (`mde_tpu/ops/resize.py:103`, with its taps
`_linear_weights_align_corners` :29): taps in float64 rounded to float32,
two float32 einsums over NHWC arrays. `evaluate`'s save path resizes each
prediction to its GT's shape with it, on the host, as the JAX package does.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear align_corners=True resize of (N, C, H, W) to out_hw."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    work = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else torch.float64
    y = F.interpolate(x.to(work), size=out_hw, mode="bilinear", align_corners=True)
    return y.to(x.dtype)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch mode='nearest' (legacy, floor) resize of (N, C, H, W) to out_hw."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="nearest")


@functools.lru_cache(maxsize=128)
def _linear_weights_align_corners(in_size: int, out_size: int) -> np.ndarray:
    """Row-stochastic (out_size, in_size) bilinear weights, align_corners=True,
    float32 from float64 taps."""
    if in_size == 1 or out_size == 1:
        w = np.zeros((out_size, in_size), dtype=np.float32)
        w[:, 0] = 1.0
        return w
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    frac = src - lo
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    w[rows, lo] = 1.0 - frac
    w[rows, lo + 1] = frac
    return w.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _linear_weights_half_pixel(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear weights, torch align_corners=False
    (half-pixel centres, edge-clamped), float32 from float64 taps."""
    scale = in_size / out_size
    src = np.clip((np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, max(in_size - 2, 0))
    frac = np.clip(src - lo, 0.0, 1.0)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    w[rows, lo] = 1.0 - frac
    w[rows, np.minimum(lo + 1, in_size - 1)] += frac
    return w.astype(np.float32)


def resize_bilinear_half_pixel(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear align_corners=False resize of (..., H, W) to out_hw."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    work = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else torch.float64
    wh = torch.from_numpy(_linear_weights_half_pixel(h, out_h)).to(x.device, work)
    ww = torch.from_numpy(_linear_weights_half_pixel(w, out_w)).to(x.device, work)
    y = torch.matmul(torch.matmul(wh, x.to(work)), ww.T)  # H, then W, as the JAX package
    return y.to(x.dtype)


def resize_bilinear_align_corners_np(x: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear align_corners=True resize of a (..., H, W, C) numpy array to
    out_hw, on the host; float32."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    wh = _linear_weights_align_corners(h, out_h)
    ww = _linear_weights_align_corners(w, out_w)
    y = np.einsum("oh,...hwc->...owc", wh, x.astype(np.float32))
    y = np.einsum("pw,...owc->...opc", ww, y)
    return y.astype(np.float32)
