"""Spatial resizes, port of `mde_tpu/ops/resize.py` (NCHW).

The JAX package writes torch's interpolation semantics as separable matmuls;
here they are torch's own: bilinear with align_corners=True (decoder upsample,
flip-TTA resize) and the legacy 'nearest' (cue downsampling).

torch computes the bilinear taps in the input's precision: in float32 the
source coordinate (in-1)/(out-1)*i is off by up to ~2e-5 pixel at 640 px,
which moves outputs by as much times the local step. The JAX package builds
its taps in float64, so a float32 input is resized in float64 here and
rounded back: the two then agree to float32 rounding.
"""

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
