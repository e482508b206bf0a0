"""CSAIL's semantic-segmentation zoo (NCHW), the port of
`mde_tpu/offline/semseg_zoo.py`: the ModelBuilder's encoders (resnet18 /
resnet50 / resnet101 with or without dilation, resnext101,
mobilenetv2dilated, hrnetv2) and decoders (c1, c1_deepsup, ppm,
ppm_deepsup, upernet) behind `SegmentationModel(arch_encoder,
arch_decoder, num_classes)`.

Modules take CSAIL's names wherever CSAIL's code has the counterpart
(semantic-segmentation-pytorch, mit_semseg/models/{models,resnet,resnext,
mobilenet}.py), so `load_segmentation_model` loads a published
`encoder_epoch_*.pth` / `decoder_epoch_*.pth` pair with `load_checked`: the
encoder's `conv{1,2,3}`, `bn{1,2,3}`, `layer{s}.{b}.*` with
`downsample.{0,1}` (what `mde_tpu/offline/hrnet_convert.py:114-131` reads)
or `features.{i}.*`; the decoders' `cbr.*`, `conv_last.*`, `ppm.*`,
`ppm_conv.*`, `ppm_last_conv.*`, `fpn_in.*`, `fpn_out.*`.

The port computes what the JAX zoo computes, where that differs from
CSAIL's code (ROADMAP.md §3 pins each):
* a dilated stage dilates every block alike, its first block included
  (CSAIL's `_nostride_dilate` gives the first block's strided conv half
  the dilation), in the ResNets and in MobileNetV2;
* PPM has no `Dropout2d(0.1)` (index 3 of `conv_last` holds nothing);
* `*_deepsup` decoders run no deep-supervision branch: its tensors
  (`cbr_deepsup`, `conv_last_deepsup`) are held so a published file loads,
  and never used, as CSAIL's inference ignores them;
* UPerNet pools, convolves and then upsamples each PPM level (CSAIL
  upsamples before the conv), and runs an `fpn_out` conv on all four
  levels, the PPM's included (`fpn_out.3`, which a CSAIL file lacks).

Casts follow the JAX module, as `offline/hrnet.py`: BatchNorm in float32
and back, the logits to float32 (float64 for a float64 model) before the
resize to `seg_size` and the softmax; bf16 weights by `to_compute_dtype`,
or `cast_at_use` over float32 masters for training.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear_half_pixel
from .hrnet import C1, BasicBlock, Bottleneck, HRNetV2Trunk, _conv_bn
from .layers import BatchNorm2d, at_least_f32, compute_dtype, load_checked, to_compute_dtype

RESNET_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3),
                 "resnet101": (3, 4, 23, 3), "resnext101": (3, 4, 23, 3)}
ENCODERS = ("hrnetv2", "mobilenetv2dilated", "resnet18", "resnet18dilated", "resnet50",
            "resnet50dilated", "resnet101", "resnet101dilated", "resnext101")
DECODERS = ("c1", "c1_deepsup", "ppm", "ppm_deepsup", "upernet")
POOL_SCALES = (1, 2, 3, 6)
PPM_DIM = 512  # the pooled branches' and the fusion's width (CSAIL's PPM, UPerNet)


def _conv_bn_relu(cin, cout, kernel=1):
    """conv (no bias) + BN + ReLU, CSAIL's Sequential layout (.0 conv, .1 BN)."""
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False),
                         BatchNorm2d(cout), nn.ReLU())


class ResNetEncoder(nn.Module):
    """CSAIL's ResNet / ResNeXt trunk (deep 3x3 stem of 64, 64, 128, max
    pool), returning the four stages' maps; `dilated` runs stages 3 and 4
    at stride 1 with dilation 2 and 4 (output stride 8), as
    `mde_tpu/offline/semseg_zoo.py:72-108`."""

    def __init__(self, arch="resnet50", dilated=True):
        super().__init__()
        layers = RESNET_LAYERS[arch]
        bottleneck = arch != "resnet18"
        grouped = arch == "resnext101"
        expansion = 2 if grouped else (4 if bottleneck else 1)
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = nn.Conv2d(64, 128, 3, 1, 1, bias=False)
        self.bn3 = BatchNorm2d(128)
        inplanes, self.channels = 128, []
        for stage, planes in enumerate((128, 256, 512, 1024) if grouped else (64, 128, 256, 512)):
            if dilated and stage >= 2:
                stride, dilation = 1, 2 ** (stage - 1)
            else:
                stride, dilation = (1 if stage == 0 else 2), 1
            blocks = []
            for b in range(layers[stage]):
                first = b == 0
                ds = first and (stride != 1 or inplanes != planes * expansion)
                s = stride if first else 1
                if bottleneck:
                    blocks.append(Bottleneck(inplanes, planes, s, ds, dilation,
                                             32 if grouped else 1, expansion))
                else:
                    blocks.append(BasicBlock(inplanes, planes, s, ds, dilation))
                inplanes = planes * expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.channels.append(inplanes)

    def forward(self, x):
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in (1, 2, 3, 4):
            x = getattr(self, f"layer{i}")(x)
            outs.append(x)
        return outs


class InvertedResidual(nn.Module):
    """MobileNetV2's block in CSAIL's layout (`conv.{k}`): 1x1 expansion
    (none at ratio 1), the depthwise 3x3 (stride, dilation), the 1x1
    projection, BN after each, ReLU6 after the first two; the residual where
    the stride is 1 and the widths agree."""

    def __init__(self, inp, oup, stride, expand_ratio, dilation=1):
        super().__init__()
        hidden = inp * expand_ratio
        self.use_res_connect = stride == 1 and inp == oup
        layers = [] if expand_ratio == 1 else [nn.Conv2d(inp, hidden, 1, bias=False),
                                               BatchNorm2d(hidden), nn.ReLU6()]
        layers += [nn.Conv2d(hidden, hidden, 3, stride, dilation, dilation, hidden, bias=False),
                   BatchNorm2d(hidden), nn.ReLU6(),
                   nn.Conv2d(hidden, oup, 1, bias=False), BatchNorm2d(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res_connect else y


# (expand ratio, out channels, repeats, stride), CSAIL mobilenet.py
_MOBILENETV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2Dilated(nn.Module):
    """mobilenetv2dilated: MobileNetV2's `features` without the last 1x1
    conv, output stride 8: past 1/8 a stage's stride becomes a doubled
    dilation (`mde_tpu/offline/semseg_zoo.py:137-158`). Returns the last map
    (320 channels)."""

    def __init__(self):
        super().__init__()
        features = [nn.Sequential(nn.Conv2d(3, 32, 3, 2, 1, bias=False), BatchNorm2d(32),
                                  nn.ReLU6())]
        inp, dilation = 32, 1
        for si, (t, c, n, s) in enumerate(_MOBILENETV2):
            for b in range(n):
                stride = s if b == 0 else 1
                if si >= 3 and stride == 2:
                    stride, dilation = 1, dilation * 2
                features.append(InvertedResidual(inp, c, stride, t, dilation))
                inp = c
        self.features = nn.Sequential(*features)
        self.channels = [inp]

    def forward(self, x):
        return [self.features(x)]


class PPM(nn.Module):
    """The pyramid-pooling decoder (CSAIL's PPM): each scale's adaptive
    average pool, 1x1 conv + BN + ReLU, half-pixel upsample to the last map;
    their concat with it, 3x3 conv + BN + ReLU, 1x1 conv to the classes."""

    def __init__(self, num_classes=150, fc_dim=2048):
        super().__init__()
        self.ppm = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(scale), *_conv_bn_relu(fc_dim, PPM_DIM))
            for scale in POOL_SCALES)
        self.conv_last = nn.Sequential(
            *_conv_bn_relu(fc_dim + len(POOL_SCALES) * PPM_DIM, PPM_DIM, 3),
            nn.Identity(),  # CSAIL's Dropout2d(0.1), which the JAX zoo leaves out
            nn.Conv2d(PPM_DIM, num_classes, 1))

    def forward(self, conv_out):
        x = conv_out[-1]
        hw = x.shape[-2:]
        pooled = [resize_bilinear_half_pixel(branch(x), hw) for branch in self.ppm]
        return self.conv_last(torch.cat([x] + pooled, dim=1))


class UPerNet(nn.Module):
    """UPerNet (`mde_tpu/offline/semseg_zoo.py:206-256`): PPM on the last
    map, laterals of the others, the top-down sums, an `fpn_out` 3x3 conv on
    every level, all upsampled to the first level, concatenated, fused and
    classified."""

    def __init__(self, num_classes=150, fpn_inplanes=(256, 512, 1024, 2048), fpn_dim=512):
        super().__init__()
        fc_dim = fpn_inplanes[-1]
        self.ppm_pooling = nn.ModuleList(nn.AdaptiveAvgPool2d(s) for s in POOL_SCALES)
        self.ppm_conv = nn.ModuleList(_conv_bn_relu(fc_dim, fpn_dim) for _ in POOL_SCALES)
        self.ppm_last_conv = _conv_bn_relu(fc_dim + len(POOL_SCALES) * fpn_dim, fpn_dim, 3)
        self.fpn_in = nn.ModuleList(_conv_bn_relu(c, fpn_dim) for c in fpn_inplanes[:-1])
        self.fpn_out = nn.ModuleList(nn.Sequential(_conv_bn_relu(fpn_dim, fpn_dim, 3))
                                     for _ in fpn_inplanes)
        self.conv_last = nn.Sequential(_conv_bn_relu(len(fpn_inplanes) * fpn_dim, fpn_dim, 3),
                                       nn.Conv2d(fpn_dim, num_classes, 1))

    def forward(self, conv_out):
        c5 = conv_out[-1]
        hw = c5.shape[-2:]
        ppm = [c5] + [resize_bilinear_half_pixel(conv(pool(c5)), hw)
                      for pool, conv in zip(self.ppm_pooling, self.ppm_conv)]
        levels = [lateral(c) for lateral, c in zip(self.fpn_in, conv_out[:-1])]
        levels.append(self.ppm_last_conv(torch.cat(ppm, dim=1)))
        for i in range(len(levels) - 1, 0, -1):
            levels[i - 1] = levels[i - 1] + resize_bilinear_half_pixel(
                levels[i], levels[i - 1].shape[-2:])
        hw = levels[0].shape[-2:]
        fused = [resize_bilinear_half_pixel(out(level), hw)
                 for out, level in zip(self.fpn_out, levels)]
        return self.conv_last(torch.cat(fused, dim=1))


def build_encoder(arch: str) -> nn.Module:
    """An encoder of ENCODERS; its `channels` are its maps' widths."""
    if arch == "hrnetv2":
        return HRNetV2Trunk()
    if arch == "mobilenetv2dilated":
        return MobileNetV2Dilated()
    if arch in ENCODERS:  # resnext101 has no dilated variant (CSAIL models.py:96-98)
        return ResNetEncoder(arch.replace("dilated", ""), dilated="dilated" in arch)
    raise ValueError(f"unknown encoder {arch}; the zoo has {ENCODERS}")


def build_decoder(arch: str, num_classes: int, channels) -> nn.Module:
    """A decoder of DECODERS on an encoder whose maps have `channels`; a
    `_deepsup` one holds the deep-supervision branch's tensors, unused."""
    if arch not in DECODERS:
        raise ValueError(f"unknown decoder {arch}; the zoo has {DECODERS}")
    fc_dim = channels[-1]
    if arch.startswith("c1"):
        decoder = C1(num_classes, fc_dim)
    elif arch.startswith("ppm"):
        decoder = PPM(num_classes, fc_dim)
    else:
        decoder = UPerNet(num_classes, tuple(channels))
    if arch.endswith("_deepsup"):
        decoder.cbr_deepsup = _conv_bn(fc_dim // 2, fc_dim // 4)
        decoder.conv_last_deepsup = nn.Conv2d(fc_dim // 4, num_classes, 1)
    return decoder


class SegmentationModel(nn.Module):
    """`encoder` + `decoder` (CSAIL's SegmentationModule and ModelBuilder,
    models.py:22-160). Returns float32 softmax scores at `seg_size`, or
    float32 log-softmax at the model's resolution without it; float64 for
    a float64 model."""

    def __init__(self, arch_encoder="hrnetv2", arch_decoder="c1", num_classes=150):
        super().__init__()
        self.encoder = build_encoder(arch_encoder)
        self.decoder = build_decoder(arch_decoder, num_classes, self.encoder.channels)

    @property
    def dtype(self):
        return compute_dtype(self.encoder.conv1 if hasattr(self.encoder, "conv1")
                             else self.encoder.features[0][0])

    def forward(self, x, seg_size=None):
        feats = self.encoder(x.to(self.dtype))
        y = at_least_f32(self.decoder([feats] if torch.is_tensor(feats) else feats))
        if seg_size is not None:
            return torch.softmax(resize_bilinear_half_pixel(y, seg_size), dim=1)
        return torch.log_softmax(y, dim=1)


def load_segmentation_model(arch_encoder: str, arch_decoder: str, encoder_path: str,
                            decoder_path: str, num_classes: int = 150,
                            dtype=torch.float32) -> SegmentationModel:
    """A CSAIL encoder/decoder pair (plain state_dicts) into the zoo's model
    on the CPU, in eval mode, its convolutions in `dtype`; a missing or
    unexpected key raises, named."""
    with torch.device("meta"):  # no initialisation: every tensor comes from the files
        model = SegmentationModel(arch_encoder, arch_decoder, num_classes)
    for part, path in ((model.encoder, encoder_path), (model.decoder, decoder_path)):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        load_checked(part, sd, path)
    return to_compute_dtype(model, dtype).eval()
