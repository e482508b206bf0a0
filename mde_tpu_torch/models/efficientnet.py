"""EfficientNet encoder (tf_efficientnet_b1_ap / b5_ap), port of
`mde_tpu/models/efficientnet.py`, native path only, NCHW.

Module and parameter names are gen-efficientnet's (conv_stem, bn1,
blocks.{stage}.{rep}.*, conv_head, bn2), so the reference's state_dicts load
as they are. The W-packed stage-0 layout of the JAX package is a TPU lane
trick and is not ported. In training mode the BatchNorms update their running
variance as flax does (models/norm.py). There is no stochastic depth: its
rate is 0, the JAX default (`mde_tpu/models/efficientnet.py:367-370`), and a
rate above 0 is not ported (ROADMAP queue 1, item 2).

`remat=True` (`--remat encoder`) checkpoints each MBConv block, the blocks
JAX wraps in `nn.remat` (`mde_tpu/models/efficientnet.py:390-392`): in a
training forward that records gradients a block keeps only its input, and
its forward runs again in the backward, under `norm.recomputation()` so
that its BatchNorms update their running stats once.

Tensor parallelism (`models/tp.py` sets `tp`, the rank's `parallel.Grid`):
`conv_head` holds this rank's rows of output channels; its output is
gathered over the model group before `bn2` and the decoder read it
(features[11]).

The encoder returns the feature-list contract the decoder relies on:
    features[0]  input
    features[1]  conv_stem out          features[2] stem BN out
    features[3]  stem act out
    features[4..10]  the 7 MBConv stage outputs
    features[11] conv_head out          features[12] head BN  features[13] head act
"""

import contextlib
import math

import torch
import torch.utils.checkpoint
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import copy_to_model, gather_from_model
from .norm import BatchNorm2d, recomputation

# B0 stage table: (expand_ratio, kernel, stride, base_channels, base_repeats)
_B0_STAGES = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

EFFICIENTNET_CONFIGS = {
    # name: (width_mult, depth_mult)
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b5": (1.6, 2.2),
}

_BN_EPS_TF = 1e-3      # tf_ variants use eps 1e-3
_BN_MOMENTUM = 0.01    # flax momentum 0.99


def round_channels(channels: float, multiplier: float, divisor: int = 8) -> int:
    """EfficientNet channel rounding (round-to-divisor, never below 90%)."""
    channels *= multiplier
    new_c = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * channels:
        new_c += divisor
    return int(new_c)


def round_repeats(repeats: int, multiplier: float) -> int:
    return int(math.ceil(repeats * multiplier))


def stage_channels(arch: str):
    """Output channels of the 7 stages (features[4..10]) and of conv_head."""
    width, _ = EFFICIENTNET_CONFIGS[arch]
    return (tuple(round_channels(c, width) for (_, _, _, c, _) in _B0_STAGES),
            round_channels(1280, width))


class Conv2dSame(nn.Conv2d):
    """Conv2d with TF-'SAME' padding: total pad max((ceil(i/s)-1)*s + k - i, 0)
    per axis, the extra row/column on the bottom/right."""

    def forward(self, x):
        pads = []
        for i, k, s in zip(x.shape[-2:], self.kernel_size, self.stride):
            total = max((-(i // -s) - 1) * s + k - i, 0)
            pads.append((total // 2, total - total // 2))
        (top, bottom), (left, right) = pads
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


def _recompute_contexts():
    """checkpoint's (forward, recomputation) contexts."""
    return contextlib.nullcontext(), recomputation()


def _bn(chs):
    return BatchNorm2d(chs, eps=_BN_EPS_TF, momentum=_BN_MOMENTUM)


class SqueezeExcite(nn.Module):
    """SE gate; the reduction comes from the block *input* channels
    (gen-efficientnet convention), passed in as reduced_chs."""

    def __init__(self, chs: int, reduced_chs: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, reduced_chs, 1)
        self.conv_expand = nn.Conv2d(reduced_chs, chs, 1)

    def forward(self, x):
        gates = x.mean(dim=(2, 3), keepdim=True)
        gates = self.conv_expand(F.silu(self.conv_reduce(gates)))
        return x * torch.sigmoid(gates)


class DepthwiseSeparableBlock(nn.Module):
    """Stage-0 block: dw conv -> BN -> SiLU -> SE -> pw conv -> BN (+skip)."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int, stride: int,
                 se_reduced_chs: int):
        super().__init__()
        self.conv_dw = Conv2dSame(in_chs, in_chs, kernel, stride, groups=in_chs,
                                  bias=False)
        self.bn1 = _bn(in_chs)
        self.se = SqueezeExcite(in_chs, se_reduced_chs)
        self.conv_pw = nn.Conv2d(in_chs, out_chs, 1, bias=False)
        self.bn2 = _bn(out_chs)
        self.has_skip = stride == 1 and in_chs == out_chs

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_dw(x)))
        y = self.bn2(self.conv_pw(self.se(y)))
        return y + x if self.has_skip else y


class InvertedResidualBlock(nn.Module):
    """MBConv: pw expand -> dw -> SE -> pw project, with skip."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int, stride: int,
                 expand_ratio: int, se_reduced_chs: int):
        super().__init__()
        mid_chs = in_chs * expand_ratio
        self.conv_pw = nn.Conv2d(in_chs, mid_chs, 1, bias=False)
        self.bn1 = _bn(mid_chs)
        self.conv_dw = Conv2dSame(mid_chs, mid_chs, kernel, stride, groups=mid_chs,
                                  bias=False)
        self.bn2 = _bn(mid_chs)
        self.se = SqueezeExcite(mid_chs, se_reduced_chs)
        self.conv_pwl = nn.Conv2d(mid_chs, out_chs, 1, bias=False)
        self.bn3 = _bn(out_chs)
        self.has_skip = stride == 1 and in_chs == out_chs

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = F.silu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(self.se(y)))
        return y + x if self.has_skip else y


class EfficientNetEncoder(nn.Module):
    """EfficientNet trunk returning the full intermediate-feature list."""

    def __init__(self, arch: str = "efficientnet-b1", in_chs: int = 3, remat: bool = False):
        super().__init__()
        self.arch = arch
        self.remat = remat
        width, depth = EFFICIENTNET_CONFIGS[arch]
        stem_chs = round_channels(32, width)
        head_chs = round_channels(1280, width)
        self.conv_stem = Conv2dSame(in_chs, stem_chs, 3, 2, bias=False)
        self.bn1 = _bn(stem_chs)

        stages = []
        chs = stem_chs
        for expand, kernel, stride, base_c, base_r in _B0_STAGES:
            out_chs = round_channels(base_c, width)
            blocks = []
            for rep in range(round_repeats(base_r, depth)):
                s = stride if rep == 0 else 1
                se_reduced = max(1, int(chs * 0.25))
                if expand == 1:
                    blocks.append(DepthwiseSeparableBlock(chs, out_chs, kernel, s,
                                                          se_reduced))
                else:
                    blocks.append(InvertedResidualBlock(chs, out_chs, kernel, s,
                                                        expand, se_reduced))
                chs = out_chs
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = nn.Conv2d(chs, head_chs, 1, bias=False)
        self.bn2 = _bn(head_chs)
        self.tp = None

    def forward(self, x):
        features = [x]
        y = self.conv_stem(x)
        features.append(y)
        y = self.bn1(y)
        features.append(y)
        y = F.silu(y)
        features.append(y)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage in self.blocks:
            for block in stage:
                y = (torch.utils.checkpoint.checkpoint(
                    block, y, use_reentrant=False, context_fn=_recompute_contexts)
                    if remat else block(y))
            features.append(y)
        if self.tp is None:
            y = self.conv_head(y)
        else:  # column-parallel: this rank's channels, then all of them
            y = gather_from_model(self.conv_head(copy_to_model(y)), 1)
        features.append(y)
        y = self.bn2(y)
        features.append(y)
        features.append(F.silu(y))
        return features
