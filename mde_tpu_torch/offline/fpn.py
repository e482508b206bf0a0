"""FPN neck, the port of `mde_tpu/offline/fpn.py` (:13-33): lateral 1x1,
top-down nearest upsample, 3x3 output convs, P6 the stride-2 1x1 max pool of
P5 (`x[:, :, ::2, ::2]`); num_outs 5. Names are mmdet's
`neck.lateral_convs.{i}.conv` and `neck.fpn_convs.{i}.conv`."""

import torch.nn as nn

from ..ops.resize import resize_nearest
from .layers import compute_dtype


class _ConvModule(nn.Module):
    """mmdet's ConvModule without norm or activation: its weights under `conv`."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels=(128, 256, 512, 1024), out_channels=256, num_outs=5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(_ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(_ConvModule(out_channels, out_channels, 3)
                                       for _ in in_channels)

    def forward(self, inputs):
        dtype = compute_dtype(self.lateral_convs[0].conv)
        laterals = [conv(x.to(dtype)) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i],
                                                               laterals[i - 1].shape[-2:])
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        if self.num_outs > len(outs):
            outs.append(outs[-1][:, :, ::2, ::2])
        return outs
