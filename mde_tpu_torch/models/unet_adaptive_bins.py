"""UnetAdaptiveBins: EfficientNet encoder -> UNet decoder -> mViT bins head,
with biological-cue insertion, port of `mde_tpu/models/unet_adaptive_bins.py`
(reference models/unet_adaptive_bins.py:119-395), NCHW.

Module names are the reference's (`encoder.original_model`, `decoder`,
`adaptive_bins_layer`, `conv_out.0`, the CueMLPs' `<name>.0` / `<name>.2`),
so its state_dicts load with strict=True.

Cues (embedded by cues/embedders.py) are concatenated onto the image at
`insertion_point="input"`, which widens the stem conv, or onto the decoder
map before the mViT at "before-attn" (after a nearest resize to its size),
which widens the mViT's patch conv and conv3x3. Area and size channels go
through a CueMLP first; instance areas are divided by the input's pixel
count at both points. `image="none"` drops the three RGB channels after the
input insertion. Where a channel count decides a module's width, it comes
from `get_num_channels_to_add`, the reference's contract.

The noAdaBins encoders ("efficientnet-b1-noAdaBins") end at the decoder,
whose conv3 gives one channel: depth = ReLU(conv3) + 1e-4, with no bins, no
mViT and so no before-attn cues.

AdaBins head: `conv_out.0` is a Conv2d(128, n_bins, 1). With `fused_head` set
and `fused_head_supported(h, w, n_bins)` true, its weight and bias go to the
fused bins-head wrapper, which launches the CUDA kernel for CUDA tensors and
runs the plain version for CPU tensors; otherwise the head runs as the
reference writes it (conv, softmax over bins, centers sum). The fused head is
differentiable (its backward is a CUDA kernel too), so training takes the
same switch. `forward(..., generator)` draws the mViT dropout masks in
training mode from `generator`. `remat="encoder"` checkpoints the encoder's
blocks (models/efficientnet.py).

Under tensor parallelism `conv_out.0` holds this rank's rows of bins, and
its weight and bias are gathered over the model group at use
(`models/tp.py`): every rank runs the whole head, fused or plain, as JAX's
`fused_bins_head_sharded` runs the kernel with its weight replicated.

`n_query_channels` (128, the reference's) is the number of mViT tokens
after the first that become range-attention queries, and conv_out's input
width; an input needs n_query_channels + 1 tokens. Below 129 tokens the
JAX model slices fewer queries and builds conv_out on them
(`mde_tpu/models/mvit.py`'s `tgt[:, 1:129]`), which a port model with that
many queries computes: the tests use that at small sizes.

Outputs: (bin_edges (N, n_bins + 1), or None for noAdaBins;
pred (N, 1, H/2, W/2)).
"""

import sys
from typing import Optional

import torch
import torch.nn as nn

from ..kernels.bins_head import fused_bins_head, fused_head_supported
from ..ops.bins import bin_centers, bin_edges_from_widths, depth_from_bins
from ..ops.resize import resize_nearest
from .decoder import DecoderBN
from .efficientnet import EfficientNetEncoder, stage_channels
from .mvit import MViT

_PATCH = 16


def get_num_channels_to_add(encoder_name: str, semantics_mode: Optional[str],
                            instance_segmentation_mode: Optional[str],
                            image: str) -> int:
    """Channel-count contract for cue insertion
    (reference unet_adaptive_bins.py:363-395)."""
    num = 0
    if semantics_mode is not None:
        if "raw" in semantics_mode:
            num += 1
        elif semantics_mode == "glove":
            num += 300
        elif "glove-25d" in semantics_mode:
            num += 25
        else:
            sys.exit("Error [mde_tpu_torch/models/unet_adaptive_bins.py]: semantics mode "
                     "not recognised")
        if "inst-areas" in semantics_mode:
            num += 10
        if "human-sizes" in semantics_mode:
            num += 10
    if instance_segmentation_mode is not None:
        if instance_segmentation_mode == "raw":
            num += 1
        elif instance_segmentation_mode == "coco" or "ade20k_swin" in instance_segmentation_mode:
            num += 35  # 25 label-embedding channels + 10 processed-area channels
        if "human_sizes" in instance_segmentation_mode:
            num += 10
    return num


def CueMLP(in_channels: int) -> nn.Sequential:
    """1x1-conv MLP for area / size cue channels: C -> 10 -> 10 with ReLU
    (reference unet_adaptive_bins.py:146-174)."""
    return nn.Sequential(nn.Conv2d(in_channels, 10, 1), nn.ReLU(),
                         nn.Conv2d(10, 10, 1), nn.ReLU())


class Encoder(nn.Module):
    """Holder giving the reference's `encoder.original_model.*` names."""

    def __init__(self, arch: str, in_chs: int = 3, remat: bool = False):
        super().__init__()
        self.original_model = EfficientNetEncoder(arch, in_chs, remat)

    def forward(self, x):
        return self.original_model(x)


class UnetAdaptiveBins(nn.Module):
    def __init__(self, n_bins: int = 100, min_val: float = 0.1, max_val: float = 10.0,
                 norm: str = "linear", encoder_name: str = "efficientnet-b5",
                 semantics_mode=None, instance_segmentation_mode=None,
                 insertion_point: str = "before-attn", image: str = "rgb",
                 fused_head: bool = False, remat: str = "none",
                 n_query_channels: int = 128):
        super().__init__()
        self.n_bins = n_bins
        # token 0 regresses the bins, the next n_query_channels are the queries
        self.min_tokens = n_query_channels + 1
        self.min_val = min_val
        self.max_val = max_val
        self.fused_head = fused_head
        self.semantics_mode = semantics_mode
        self.instance_segmentation_mode = instance_segmentation_mode
        self.image = image
        self.no_adabins = "noAdaBins" in encoder_name
        # cues go in at the input, or before the mViT where there is one
        self.cues_at = (insertion_point if insertion_point == "input"
                        or (insertion_point == "before-attn" and not self.no_adabins)
                        else None)
        n_cues = get_num_channels_to_add(encoder_name, semantics_mode,
                                         instance_segmentation_mode, image)
        if self.cues_at == "before-attn" and semantics_mode and "human-sizes" in semantics_mode:
            raise ValueError(
                "semantics human-sizes with insertion_point='before-attn' is not a "
                "working configuration in the reference (the cue channels are "
                "concatenated onto an unused tensor at unet_adaptive_bins.py:256-259 "
                "and the mViT channel count mismatches); use insertion_point='input'.")
        in_chs = 3 + (n_cues if self.cues_at == "input" else 0)
        if image == "none":
            if in_chs <= 3:
                raise ValueError("Error: Add more auxiliary information at input if using "
                                 "no image")
            in_chs -= 3

        if self.cues_at is not None:
            if semantics_mode == "glove-25d-inst-areas":
                self.semantics_areas_fc = CueMLP(1)
            elif semantics_mode is not None and "human-sizes" in semantics_mode:
                self.semantics_absolute_sizes_fc = CueMLP(3)
            if instance_segmentation_mode is not None:
                self.instance_areas_fc = CueMLP(1)
                if "human_sizes" in instance_segmentation_mode:
                    self.instance_absolute_sizes_fc = CueMLP(3)

        arch = "efficientnet-b5" if "efficientnet-b5" in encoder_name else "efficientnet-b1"
        stage_chs, head_chs = stage_channels(arch)
        self.encoder = Encoder(arch, in_chs, remat=remat == "encoder")
        self.decoder = DecoderBN(num_features=head_chs, num_classes=128,
                                 skip_chs=(stage_chs[0], stage_chs[1],
                                           stage_chs[2], stage_chs[4]),
                                 mode="noAdaBins" if self.no_adabins else "AdaBins")
        if not self.no_adabins:
            mvit_chs = 128 + (n_cues if self.cues_at == "before-attn" else 0)
            self.adaptive_bins_layer = MViT(mvit_chs, n_query_channels=n_query_channels,
                                            patch_size=_PATCH, dim_out=n_bins,
                                            embedding_dim=128, norm=norm)
            self.conv_out = nn.Sequential(nn.Conv2d(n_query_channels, n_bins, 1, 1, 0),
                                          nn.Softmax(dim=1))

    def _with_cues(self, x, semantics, instance_labels, instance_areas, image_pixels):
        """x with the cue channels concatenated, in the reference's order."""
        parts = [x]
        sem_mode, inst_mode = self.semantics_mode, self.instance_segmentation_mode
        if semantics is not None:
            if sem_mode == "glove-25d-inst-areas":
                parts += [semantics[:, 0:25], self.semantics_areas_fc(semantics[:, 25:26])]
            elif sem_mode is not None and "human-sizes" in sem_mode:
                parts += [semantics[:, :-3],
                          self.semantics_absolute_sizes_fc(semantics[:, -3:])]
            else:
                parts.append(semantics)
        if instance_labels is not None:
            parts.append(instance_labels)
        if instance_areas is not None:
            if inst_mode is not None and "human_sizes" in inst_mode:
                parts += [self.instance_areas_fc(instance_areas[:, 0:1] / image_pixels),
                          self.instance_absolute_sizes_fc(instance_areas[:, 1:4])]
            else:
                parts.append(self.instance_areas_fc(instance_areas / image_pixels))
        return torch.cat(parts, 1)

    def forward(self, x, semantics=None, instance_labels=None, instance_areas=None,
                generator=None):
        """x (N, 3, H, W); the cues as the embedders give them: `semantics`
        embedding (+ area / size) channels, `instance_labels` embedding
        channels, `instance_areas` area (+ 3 size) channels, all (N, C, H, W)."""
        image_pixels = x.shape[-2] * x.shape[-1]
        if self.cues_at == "input":
            x = self._with_cues(x, semantics, instance_labels, instance_areas, image_pixels)
        if self.image == "none":
            x = x[:, 3:]

        features = self.encoder(x)
        unet_out = self.decoder(features)
        if self.no_adabins:
            # direct depth head; ReLU + eps keeps SILog finite
            # (reference unet_adaptive_bins.py:240-242)
            return None, torch.relu(unet_out.float()) + 1e-4

        h, w = unet_out.shape[-2:]
        if self.cues_at == "before-attn":
            unet_out = self._with_cues(
                unet_out, *(None if c is None else resize_nearest(c, (h, w))
                            for c in (semantics, instance_labels, instance_areas)),
                image_pixels)
        if (h // _PATCH) * (w // _PATCH) < self.min_tokens:
            raise ValueError(
                f"the mViT head needs at least {self.min_tokens} tokens, "
                f"(H/32)*(W/32) for an HxW input; a {h}x{w} decoder map gives "
                f"{(h // _PATCH) * (w // _PATCH)}")
        bin_widths_normed, range_attention_maps = self.adaptive_bins_layer(unet_out, generator)
        bin_edges = bin_edges_from_widths(bin_widths_normed, self.min_val, self.max_val)
        centers = bin_centers(bin_edges)

        # the kernels take 128 channels, as JAX's model asks (cin == 128)
        if (self.fused_head and range_attention_maps.shape[1] == 128
                and fused_head_supported(h, w, self.n_bins)):
            conv = self.conv_out[0]
            pred = fused_bins_head(range_attention_maps, conv.weight, conv.bias, centers)
        else:
            pred = depth_from_bins(self.conv_out(range_attention_maps).float(), centers)
        return bin_edges, pred


def build_model(args, n_bins=None) -> UnetAdaptiveBins:
    """Construct the model from a parsed args namespace (the reference's
    UnetAdaptiveBins.build surface minus torch.hub fetching)."""
    return UnetAdaptiveBins(
        n_bins=n_bins if n_bins is not None else args.n_bins,
        min_val=args.min_depth, max_val=args.max_depth,
        norm=getattr(args, "norm", "linear"),
        encoder_name=args.encoder_name,
        semantics_mode=args.use_semantics,
        instance_segmentation_mode=args.use_instance_segmentation,
        insertion_point=args.insertion_point,
        image=args.image,
        fused_head=bool(getattr(args, "use_fused_head", False)),
        remat=getattr(args, "remat", "none") or "none",
    )
