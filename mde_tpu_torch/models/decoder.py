"""UNet decoder over EfficientNet skips, port of `mde_tpu/models/decoder.py`
(reference unet_adaptive_bins.py:39-100), NCHW.

The reference's conv2 quirk is kept: a 1x1 conv declared with padding=1, which
grows the bottleneck map by a 2-pixel border that the first upsample resizes
away. Skips are features[8], [6], [5], [4] and the bottleneck is features[11],
the conv_head output before its BN. In training mode the BatchNorms update
their running variance as flax does (models/norm.py), with flax momentum 0.9.
"""

import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear_align_corners
from .norm import BatchNorm2d

_BN_EPS = 1e-5  # torch nn.BatchNorm2d default


class UpSampleBN(nn.Module):
    """Upsample to the skip's size, concat, then (conv3x3 BN LeakyReLU) x2."""

    def __init__(self, skip_input: int, output_features: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(skip_input, output_features, 3, 1, 1),
            BatchNorm2d(output_features, eps=_BN_EPS),
            nn.LeakyReLU(0.01),
            nn.Conv2d(output_features, output_features, 3, 1, 1),
            BatchNorm2d(output_features, eps=_BN_EPS),
            nn.LeakyReLU(0.01),
        )

    def forward(self, x, concat_with):
        up_x = resize_bilinear_align_corners(x, concat_with.shape[-2:])
        return self._net(torch.cat([up_x, concat_with], dim=1))


class DecoderBN(nn.Module):
    """4-stage UNet decoder (reference unet_adaptive_bins.py:56-100).

    skip_chs: channels of features[4], [5], [6], [8] (stage outputs 0, 1, 2, 4).
    """

    def __init__(self, num_features: int = 1280, num_classes: int = 128,
                 skip_chs=(16, 24, 40, 112)):
        super().__init__()
        f = num_features
        c0, c1, c2, c3 = skip_chs
        self.conv2 = nn.Conv2d(f, f, 1, 1, 1)
        self.up1 = UpSampleBN(f + c3, f // 2)
        self.up2 = UpSampleBN(f // 2 + c2, f // 4)
        self.up3 = UpSampleBN(f // 4 + c1, f // 8)
        self.up4 = UpSampleBN(f // 8 + c0, f // 16)
        self.conv3 = nn.Conv2d(f // 16, num_classes, 3, 1, 1)

    def forward(self, features):
        x_block0, x_block1, x_block2, x_block3, x_block4 = (
            features[4], features[5], features[6], features[8], features[11])
        x_d0 = self.conv2(x_block4)
        x_d1 = self.up1(x_d0, x_block3)
        x_d2 = self.up2(x_d1, x_block2)
        x_d3 = self.up3(x_d2, x_block1)
        x_d4 = self.up4(x_d3, x_block0)
        return self.conv3(x_d4)
