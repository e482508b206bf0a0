"""Fused AdaBins bins head: 1x1 conv -> softmax over bins -> bin-centers sum,
port of `mde_tpu/kernels/bins_head.py`, forward and backward.

`fused_bins_head` runs the hand-written CUDA kernels of `csrc/bins_head.cu`
for CUDA tensors, through `FusedBinsHead`, an autograd.Function whose forward
launches the forward kernel (replacing the Pallas `_fwd_kernel`) and whose
backward launches the backward kernel (replacing `_bwd_kernel`) and folds its
per-block partials as `_fused_core_bwd` folds its per-tile ones. For CPU
tensors it runs `fused_bins_head_reference`, the plain PyTorch version with
the same bf16 rounding points, and autograd differentiates that. There is no
fallback between the two: a CUDA tensor the kernels cannot take raises.

The model (models/unet_adaptive_bins.py) takes this path only where
`fused_head_supported` holds, which needs at least 129 mViT tokens for the
128-channel map as well. The JAX test of the fused model path
(`tests/test_kernels.py::test_fused_head_model_path_matches_unfused`) runs at
64x128, which is 8 tokens, so it never reaches the kernel; the port's slice
tests (`tests/test_torch_port_slice.py`, `tests/test_torch_port_train.py`)
run the model through the fused head at 320x416 (130 tokens).
"""

import ctypes

import torch

from ..ops.bins import depth_from_bins
from . import build

_CHANNELS = 128
_SOURCE = "bins_head.cu"
_LIB = None

# Kernel launches since the last reset, forward and backward; only the CUDA
# path adds to them. One backward call launches two kernels (the pixel and
# the weight kernel) and adds 2.
LAUNCHES = 0
BWD_LAUNCHES = 0


def fused_head_supported(h: int, w: int, n_bins: int) -> bool:
    """The shapes at which the model takes the fused head (the predicate of
    `mde_tpu/kernels/bins_head.py::fused_head_supported`)."""
    return (h * w) % _CHANNELS == 0 and n_bins % _CHANNELS == 0


def fused_bins_head_reference(features_nchw: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Plain version: the unfused conv_out -> softmax -> depth_from_bins path.

    With bf16 features the logits are accumulated in f32 from bf16 operands,
    rounded to bf16, the bf16 bias is added in bf16, and the softmax runs in
    f32 — the rounding points of the JAX kernel and its test reference.
    Autocast is off inside, so these points hold under it too.
    """
    with torch.autocast(features_nchw.device.type, enabled=False):
        return _reference(features_nchw, weight, bias, centers)


def _reference(features_nchw, weight, bias, centers):
    x = features_nchw
    w = weight.reshape(weight.shape[0], -1).to(x.dtype).float()
    logits = torch.einsum("bchw,nc->bnhw", x.float(), w)
    if x.dtype == torch.bfloat16:
        logits = (logits.to(torch.bfloat16) + bias.to(torch.bfloat16)[:, None, None]).float()
    else:
        logits = logits + bias.float()[:, None, None]
    probs = torch.softmax(logits, dim=1)
    return depth_from_bins(probs, centers.float())


def _check(features, weight, bias, centers):
    if features.dim() != 4 or features.shape[1] != _CHANNELS:
        raise ValueError(f"fused bins head expects (B, {_CHANNELS}, H, W) features, "
                         f"got {tuple(features.shape)}")
    b = features.shape[0]
    n = weight.shape[0]
    if n % _CHANNELS:
        raise ValueError(f"fused bins head needs a bin count that is a multiple "
                         f"of {_CHANNELS}, got {n}")
    if weight.numel() != n * _CHANNELS or tuple(bias.shape) != (n,) \
            or tuple(centers.shape) != (b, n):
        raise ValueError(f"shapes do not agree: weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}, centers {tuple(centers.shape)} "
                         f"for {n} bins and batch {b}")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    for name, t in (("weight", weight), ("bias", bias), ("centers", centers)):
        if name != "centers" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != features.device:
            raise ValueError(f"{name} is on {t.device}, features on {features.device}")


def fused_bins_head(features_nchw: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Depth from the decoder's range-attention maps without materializing
    the bin logits; differentiable in all four inputs.

    features_nchw: (B, 128, H, W) float32 or bfloat16
    weight:        (n_bins, 128, 1, 1) float32, the conv_out.0 weight
    bias:          (n_bins,) float32
    centers:       (B, n_bins) adaptive bin centers, taken in float32
    Returns (B, 1, H, W) float32.
    """
    centers = centers.float()
    _check(features_nchw, weight, bias, centers)
    if features_nchw.device.type == "cpu":
        return fused_bins_head_reference(features_nchw, weight, bias, centers)
    if features_nchw.device.type != "cuda":
        raise ValueError(f"no bins-head kernel for device {features_nchw.device}")
    for name, t in (("features", features_nchw), ("weight", weight),
                    ("bias", bias), ("centers", centers)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return FusedBinsHead.apply(features_nchw, weight, bias, centers)


class FusedBinsHead(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op. The
    amp decorators keep the dtypes as they come under autocast: features in
    their dtype, weight, bias and centers in float32."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, centers):
        ctx.save_for_backward(x, weight, bias, centers)
        return _launch(x, weight, bias, centers)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad):
        x, weight, bias, centers = ctx.saved_tensors
        dx, dw, db, dc = _launch_bwd(x, weight, bias, centers, grad)
        return dx, dw.reshape(weight.shape), db, dc


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc runs here on first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load(_SOURCE)
        lib.mde_bins_head_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.mde_bins_head_fwd.restype = ctypes.c_int
        lib.mde_bins_head_bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.mde_bins_head_bwd.restype = ctypes.c_int
        for fn in (lib.mde_bins_head_bwd_pixels_per_block,
                   lib.mde_bins_head_bwd_weight_pixels_per_block):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.mde_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mde_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(x, weight, bias, centers):
    global LAUNCHES
    lib = library()
    b, _, h, w = x.shape
    out = torch.empty((b, 1, h, w), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mde_bins_head_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), weight.data_ptr(),
        bias.data_ptr(), centers.data_ptr(), out.data_ptr(), b, h * w,
        weight.shape[0], x.device.index, stream)
    if err != 0:
        raise RuntimeError("bins-head kernel launch failed: "
                           + lib.mde_cuda_error_string(err).decode())
    LAUNCHES += 1
    return out


def _launch_bwd(x, weight, bias, centers, grad):
    """The backward kernels; returns (dx, dW (n_bins, 128), db, dcenters)
    with the per-block partials folded."""
    global BWD_LAUNCHES
    lib = library()
    b, _, h, w = x.shape
    hw, n = h * w, weight.shape[0]
    g = grad.float().contiguous()
    blocks = -(-hw // lib.mde_bins_head_bwd_pixels_per_block())
    dw_blocks = -(-hw // lib.mde_bins_head_bwd_weight_pixels_per_block())
    dx = torch.empty_like(x)
    stats = torch.empty((3, b, hw), dtype=torch.float32, device=x.device)
    part_dbc = torch.empty((2, b, blocks, n), dtype=torch.float32, device=x.device)
    part_dw = torch.empty((b, dw_blocks, n, _CHANNELS), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mde_bins_head_bwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), weight.data_ptr(),
        bias.data_ptr(), centers.data_ptr(), g.data_ptr(), dx.data_ptr(),
        stats.data_ptr(), part_dbc[0].data_ptr(), part_dbc[1].data_ptr(),
        part_dw.data_ptr(), b, hw, n, x.device.index, stream)
    if err != 0:
        raise RuntimeError("bins-head backward kernel launch failed: "
                           + lib.mde_cuda_error_string(err).decode())
    BWD_LAUNCHES += 2
    return dx, part_dw.sum(dim=(0, 1)), part_dbc[0].sum(dim=(0, 1)), part_dbc[1].sum(dim=1)
