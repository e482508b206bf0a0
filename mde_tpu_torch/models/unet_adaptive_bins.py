"""UnetAdaptiveBins: EfficientNet encoder -> UNet decoder -> mViT bins head,
port of `mde_tpu/models/unet_adaptive_bins.py` (reference
models/unet_adaptive_bins.py:119-395), NCHW, AdaBins head with no cues.

Module names are the reference's (`encoder.original_model`, `decoder`,
`adaptive_bins_layer`, `conv_out.0`), so its state_dicts load with
strict=True. `conv_out.0` is always a Conv2d(128, n_bins, 1). With
`fused_head` set and `fused_head_supported(h, w, n_bins)` true, its weight and
bias go to the fused bins-head wrapper, which launches the CUDA kernel for
CUDA tensors and runs the plain version for CPU tensors; otherwise the head
runs as the reference writes it (conv, softmax over bins, centers sum). The
fused head is differentiable (its backward is a CUDA kernel too), so training
takes the same switch. `forward(x, generator)` draws the mViT dropout masks in
training mode from `generator`.

Outputs: (bin_edges (N, n_bins + 1), pred (N, 1, H/2, W/2)).
"""

import torch.nn as nn

from ..kernels.bins_head import fused_bins_head, fused_head_supported
from ..ops.bins import bin_centers, bin_edges_from_widths, depth_from_bins
from .decoder import DecoderBN
from .efficientnet import EfficientNetEncoder, stage_channels
from .mvit import MViT

_MIN_TOKENS = 129  # token 0 regresses the bins, tokens 1..128 are the queries
_PATCH = 16


class Encoder(nn.Module):
    """Holder giving the reference's `encoder.original_model.*` names."""

    def __init__(self, arch: str):
        super().__init__()
        self.original_model = EfficientNetEncoder(arch)

    def forward(self, x):
        return self.original_model(x)


class UnetAdaptiveBins(nn.Module):
    def __init__(self, n_bins: int = 100, min_val: float = 0.1, max_val: float = 10.0,
                 norm: str = "linear", encoder_name: str = "efficientnet-b5",
                 semantics_mode=None, instance_segmentation_mode=None,
                 image: str = "rgb", fused_head: bool = False):
        super().__init__()
        if semantics_mode is not None or instance_segmentation_mode is not None:
            raise NotImplementedError(
                "cue insertion and CueMLP are not ported yet (ROADMAP queue 1, "
                "items 5 and 12)")
        if "noAdaBins" in encoder_name:
            raise NotImplementedError(
                "the noAdaBins head is not ported yet (ROADMAP queue 1, item 5)")
        if image == "none":
            raise NotImplementedError(
                "image 'none' needs cue channels, which are not ported yet "
                "(ROADMAP queue 1, item 5)")
        self.n_bins = n_bins
        self.min_val = min_val
        self.max_val = max_val
        self.fused_head = fused_head
        arch = "efficientnet-b5" if "efficientnet-b5" in encoder_name else "efficientnet-b1"
        stage_chs, head_chs = stage_channels(arch)
        self.encoder = Encoder(arch)
        self.decoder = DecoderBN(num_features=head_chs, num_classes=128,
                                 skip_chs=(stage_chs[0], stage_chs[1],
                                           stage_chs[2], stage_chs[4]))
        self.adaptive_bins_layer = MViT(128, n_query_channels=128, patch_size=_PATCH,
                                        dim_out=n_bins, embedding_dim=128, norm=norm)
        self.conv_out = nn.Sequential(nn.Conv2d(128, n_bins, 1, 1, 0),
                                      nn.Softmax(dim=1))

    def forward(self, x, generator=None):
        features = self.encoder(x)
        unet_out = self.decoder(features)
        h, w = unet_out.shape[-2:]
        if (h // _PATCH) * (w // _PATCH) < _MIN_TOKENS:
            raise ValueError(
                f"the mViT head needs at least {_MIN_TOKENS} tokens, "
                f"(H/32)*(W/32) for an HxW input; a {h}x{w} decoder map gives "
                f"{(h // _PATCH) * (w // _PATCH)}")
        bin_widths_normed, range_attention_maps = self.adaptive_bins_layer(unet_out, generator)
        bin_edges = bin_edges_from_widths(bin_widths_normed, self.min_val, self.max_val)
        centers = bin_centers(bin_edges)

        if self.fused_head and fused_head_supported(h, w, self.n_bins):
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
        image=args.image,
        fused_head=bool(getattr(args, "use_fused_head", False)),
    )
