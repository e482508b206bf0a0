"""HRNetV2-W48 + C1 semantic segmentation (NCHW), the port of
`mde_tpu/offline/hrnet.py` (:43-242): the offline semantics-cue generator.

The module keeps CSAILVision's names (semantic-segmentation-pytorch,
mit_semseg/models/hrnet.py and models.py `C1`): `encoder` holds the keys of
`encoder_epoch_30.pth` and `decoder` those of `decoder_epoch_30.pth`
(`cbr.0`, `cbr.1`, `conv_last`), so a published pair loads with
`load_hrnet_c1` and no conversion; they are the names
`mde_tpu/offline/hrnet_convert.py:45-148` reads. The model itself is the
zoo's (`semseg_zoo.SegmentationModel("hrnetv2", "c1")`), which also takes
this module's residual blocks and C1 for its ResNets.

Casts follow the JAX module: BatchNorm in float32, cast back to the compute
dtype; the logits go to float32 (a float64 model's stay float64) before
the resize to `seg_size` and the softmax. The exchange units' upsamples
and the C1 resize are the half-pixel matmul resize (`ops/resize.py`).

`hrnet_multiscale_inference` is the test protocol of test.py:60-103: five
scales (short side 300-600, long side at most 1000, padded to /32), the
frame resized with the port's PIL-exact bilinear resize, the five float32
softmax maps summed on the device and one argmax.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.transforms import normalize_image, resize_bilinear_pil
from ..ops.resize import resize_bilinear_half_pixel
from .layers import BatchNorm2d

_STAGE_CFG = {
    # stage: (num_modules, branch_channels, blocks_per_branch)
    2: (1, (48, 96), 4),
    3: (4, (48, 96, 192), 4),
    4: (3, (48, 96, 192, 384), 4),
}


def _conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


def _conv_bn(cin, cout, stride=1, relu=True):
    layers = [_conv3x3(cin, cout, stride), BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class Bottleneck(nn.Module):
    """1x1, 3x3 (stride, dilation, groups) and 1x1 convs to planes x
    expansion, BN after each, and a 1x1 + BN downsample where the shape
    changes (CSAIL resnet.py's Bottleneck; resnext.py's GroupBottleneck with
    groups 32 and expansion 2)."""

    def __init__(self, inplanes, planes, stride=1, has_downsample=False, dilation=1, groups=1,
                 expansion=4):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation, groups, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * expansion, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * expansion)
        self.downsample = _downsample(inplanes, planes * expansion, stride, has_downsample)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    """Two 3x3 convs (the first with the stride; both dilated), BN after
    each, and the downsample where the shape changes (CSAIL resnet.py)."""

    def __init__(self, inplanes, planes, stride=1, has_downsample=False, dilation=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, dilation, dilation, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, dilation, dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride, has_downsample)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.bn2(self.conv2(y)) + residual)


def _downsample(inplanes, outplanes, stride, has_downsample):
    if not has_downsample:
        return None
    return nn.Sequential(nn.Conv2d(inplanes, outplanes, 1, stride, bias=False),
                         BatchNorm2d(outplanes))


class ExchangeUnit(nn.Module):
    """One HighResolutionModule: per-branch BasicBlock chains + SUM fusion
    (CSAIL hrnet.py:226-250)."""

    def __init__(self, channels, num_blocks):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, c) for _ in range(num_blocks)]) for c in channels)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j == i:
                    row.append(None)
                elif j > i:  # 1x1 conv + BN, then the half-pixel upsample
                    row.append(nn.Sequential(nn.Conv2d(channels[j], channels[i], 1, bias=False),
                                             BatchNorm2d(channels[i])))
                else:  # chain of stride-2 3x3 convs; ReLU between, none at the end
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j], 2,
                                 relu=k != i - j - 1) for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                t = ys[j] if layer is None else layer(ys[j])
                if j > i:
                    t = resize_bilinear_half_pixel(t, ys[i].shape[-2:])
                acc = t if acc is None else acc + t
            fused.append(F.relu(acc))
        return fused


class HRNetV2Trunk(nn.Module):
    """The encoder: 4 parallel resolutions (48/96/192/384 channels), output
    the 720-channel concat at 1/4 of the input."""

    channels = (720,)

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if b == 0 else 256, 64,
                                                 has_downsample=b == 0) for b in range(4)])
        # transition1: branch 0 reshapes channels in place (conv, bn, relu);
        # branch 1 is a new stride-2 branch, a chain of one such Sequential
        self.transition1 = nn.ModuleList([_conv_bn(256, 48),
                                          nn.Sequential(_conv_bn(256, 96, 2))])
        for stage in (2, 3, 4):
            num_modules, channels, num_blocks = _STAGE_CFG[stage]
            if stage > 2:  # the new branch from the previous last one, stride 2
                setattr(self, f"transition{stage - 1}", nn.ModuleList(
                    [None] * (len(channels) - 1)
                    + [nn.Sequential(_conv_bn(channels[-2], channels[-1], 2))]))
            setattr(self, f"stage{stage}", nn.Sequential(
                *[ExchangeUnit(channels, num_blocks) for _ in range(num_modules)]))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.layer1(y)
        xs = [t(y) for t in self.transition1]
        for stage in (2, 3, 4):
            if stage > 2:
                xs = xs + [getattr(self, f"transition{stage - 1}")[-1](xs[-1])]
            for unit in getattr(self, f"stage{stage}"):
                xs = unit(xs)
        hw = xs[0].shape[-2:]
        return torch.cat([xs[0]] + [resize_bilinear_half_pixel(x, hw) for x in xs[1:]], dim=1)


class C1(nn.Module):
    """CSAIL's C1 decoder on the last feature map: 3x3 conv fc_dim -> fc_dim / 4
    + BN + ReLU, 1x1 -> classes."""

    def __init__(self, num_classes=150, fc_dim=720):
        super().__init__()
        self.cbr = _conv_bn(fc_dim, fc_dim // 4)
        self.conv_last = nn.Conv2d(fc_dim // 4, num_classes, 1)

    def forward(self, conv_out):
        return self.conv_last(self.cbr(conv_out[-1]))


def HRNetV2C1(num_classes=150):
    """HRNetV2-W48 + C1, `semseg_zoo.SegmentationModel("hrnetv2", "c1")`:
    float32 softmax scores at `seg_size`, or float32 log-softmax at 1/4 of
    the input without it (CSAIL models.py:363-385); float64 for a float64
    model."""
    from .semseg_zoo import SegmentationModel  # the zoo builds on this module
    return SegmentationModel("hrnetv2", "c1", num_classes)


def load_hrnet_c1(encoder_path: str, decoder_path: str, dtype=torch.float32):
    """A CSAIL encoder/decoder pair (`encoder_epoch_30.pth`,
    `decoder_epoch_30.pth`: plain state_dicts) into HRNetV2C1 on the CPU, in
    eval mode; a missing or unexpected key raises, named."""
    from .semseg_zoo import load_segmentation_model
    return load_segmentation_model("hrnetv2", "c1", encoder_path, decoder_path, dtype=dtype)


# --------------------------------------------------------------- inference

IMG_SIZES = (300, 375, 450, 525, 600)
IMG_MAX_SIZE = 1000
PADDING_CONSTANT = 32


def round2nearest_multiple(x: int, p: int) -> int:
    return ((x - 1) // p + 1) * p


def _scale_plan(h: int, w: int):
    """Per-scale resized + padded sizes (CSAIL dataset.py:121-142, 225-233)."""
    plan = []
    for short in IMG_SIZES:
        scale = min(short / float(min(h, w)), IMG_MAX_SIZE / float(max(h, w)))
        th, tw = int(h * scale), int(w * scale)
        plan.append(((th, tw),
                     (round2nearest_multiple(th, PADDING_CONSTANT),
                      round2nearest_multiple(tw, PADDING_CONSTANT))))
    return plan


def hrnet_multiscale_inference(apply_fn, img_hwc01: np.ndarray) -> np.ndarray:
    """Multi-scale segmentation of one [0, 1] float RGB image.

    apply_fn(x, seg_size) takes a (1, 3, ph, pw) float32 CPU tensor and
    returns (1, classes, H, W) softmax scores on its device. The five maps
    are summed there and reduced by one argmax (argmax of the sum is argmax
    of the mean, first maximum on ties, as np.argmax); returns the (H, W)
    int32 class map.
    """
    h, w = img_hwc01.shape[:2]
    frame = (np.clip(img_hwc01, 0, 1) * 255).astype(np.uint8)
    scores = None
    for (th, tw), (ph, pw) in _scale_plan(h, w):
        resized = resize_bilinear_pil(frame, (tw, th)).astype(np.float32) / 255.0
        pad = np.zeros((ph, pw, 3), dtype=np.float32)
        pad[:th, :tw] = normalize_image(resized)
        out = apply_fn(torch.from_numpy(pad).permute(2, 0, 1)[None], (h, w))[0]
        scores = out if scores is None else scores + out
    return torch.argmax(scores, dim=0).to(torch.int32).cpu().numpy()
