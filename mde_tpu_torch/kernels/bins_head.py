"""Fused AdaBins bins head: 1x1 conv -> softmax over bins -> bin-centers sum,
port of `mde_tpu/kernels/bins_head.py`, forward and backward.

`fused_bins_head` runs hand-written CUDA kernels for CUDA tensors, through
`FusedBinsHead`, an autograd.Function whose forward launches a forward kernel
(replacing the Pallas `_fwd_kernel`) and whose backward launches two backward
kernels (replacing `_bwd_kernel`) and folds their per-block partials in a
fixed order, as `_fused_core_bwd` folds its per-tile ones. The features' dtype
picks the kernel family: float32 goes to the CUDA-core kernels of
`csrc/bins_head.cu`, bfloat16 to the tensor-core kernels of
`csrc/bins_head_tc.cu`. Each family's forward saves each pixel's softmax
(max, sum) for its backward, which then forms p without running the softmax
again; the float32 forward does so only when a backward can follow (grad
enabled and an input that requires it), so serving writes nothing more. For
CPU tensors it runs `fused_bins_head_reference`, the plain PyTorch version
with the same bf16 rounding points: autograd differentiates it in f32, and in
bf16 `PlainBf16Head` gives the JAX kernel's gradients. There is no fallback
between the three: a CUDA tensor the kernels cannot take raises.

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
_SOURCE = "bins_head.cu"       # float32: CUDA-core kernels
_TC_SOURCE = "bins_head_tc.cu"  # bfloat16: tensor-core kernels
_LIB = None
_TC_LIB = None

# Kernel launches since the last reset, forward and backward, per family;
# only the CUDA path adds to them. One backward call launches two kernels
# (the pixel and the weight kernel) and adds 2.
LAUNCHES = 0          # CUDA-core forward (float32)
BWD_LAUNCHES = 0      # CUDA-core backward
TC_LAUNCHES = 0       # tensor-core forward (bfloat16)
TC_BWD_LAUNCHES = 0   # tensor-core backward


def fused_head_supported(h: int, w: int, n_bins: int) -> bool:
    """The shapes at which the model takes the fused head (the predicate of
    `mde_tpu/kernels/bins_head.py::fused_head_supported`)."""
    return (h * w) % _CHANNELS == 0 and n_bins % _CHANNELS == 0


def fused_bins_head_reference(features_nchw: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Plain version: the unfused conv_out -> softmax -> depth_from_bins path.

    With bf16 features the logits are accumulated in f32 from bf16 operands,
    rounded to bf16, the bf16 bias is added in bf16, and the softmax runs in
    f32 — the rounding points of the JAX kernel and its test reference. The
    gradients are `_bwd_kernel`'s (`PlainBf16Head`): W and b are rounded to
    bf16 in the forward only, and dW, db and dcenters come back in f32. f32
    features take plain autograd. Autocast is off inside, so these points
    hold under it too.
    """
    with torch.autocast(features_nchw.device.type, enabled=False):
        if features_nchw.dtype == torch.bfloat16:
            return PlainBf16Head.apply(features_nchw, weight, bias, centers)
        logits = torch.einsum("bchw,nc->bnhw", features_nchw.float(),
                              weight.reshape(weight.shape[0], -1).float())
        probs = torch.softmax(logits + bias.float()[:, None, None], dim=1)
        return depth_from_bins(probs, centers.float())


class PlainBf16Head(torch.autograd.Function):
    """The plain bf16 head with the gradients of the JAX kernel's
    `_bwd_kernel` (mde_tpu/kernels/bins_head.py:99-116): dlog = p (c - depth)
    g in f32, rounded to bf16 before both products, which sum in f32; dx
    rounded to bf16; dW = sum bf16(dlog) x^T, db = sum dlog and dcenters =
    sum p g returned in f32."""

    @staticmethod
    def forward(ctx, x, weight, bias, centers):
        w = weight.reshape(weight.shape[0], -1).to(torch.bfloat16).float()
        logits = torch.einsum("bchw,nc->bnhw", x.float(), w)
        logits = logits.to(torch.bfloat16) + bias.to(torch.bfloat16)[:, None, None]
        probs = torch.softmax(logits.float(), dim=1)
        depth = depth_from_bins(probs, centers.float())
        ctx.save_for_backward(x, weight, centers, probs, depth)
        return depth

    @staticmethod
    def backward(ctx, grad):
        x, weight, centers, probs, depth = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            pg = probs * grad.float()
            dlog = pg * (centers.float()[:, :, None, None] - depth)
            dlog_bf16 = dlog.to(torch.bfloat16).float()
            w = weight.reshape(weight.shape[0], -1).to(torch.bfloat16).float()
            dx = torch.einsum("bnhw,nc->bchw", dlog_bf16, w).to(x.dtype)
            dw = torch.einsum("bnhw,bchw->nc", dlog_bf16, x.float())
            return dx, dw.reshape(weight.shape), dlog.sum(dim=(0, 2, 3)), pg.sum(dim=(2, 3))


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
    inputs = (features_nchw, weight, bias, centers)
    for name, t in zip(("features", "weight", "bias", "centers"), inputs):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    backward = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    return FusedBinsHead.apply(*inputs, backward)


class FusedBinsHead(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op, of
    the family the features' dtype picks. Both families save the forward's
    depth and each pixel's softmax (max, sum) for the backward; the float32
    forward writes the (max, sum) only where `backward` says one can follow.
    The amp decorators keep the dtypes as they come under autocast: features
    in their dtype, weight, bias and centers in float32."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, centers, backward):
        if x.dtype == torch.bfloat16:
            out, stats = _launch_tc(x, weight, bias, centers)
        else:
            out, stats = _launch(x, weight, bias, centers, stats=backward)
        if backward:
            ctx.save_for_backward(x, weight, bias, centers, out, stats)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        launch = _launch_tc_bwd if saved[0].dtype == torch.bfloat16 else _launch_bwd
        dx, dw, db, dc = launch(*saved[:4], grad, *saved[4:])
        return dx, dw.reshape(saved[1].shape), db, dc, None


def library() -> ctypes.CDLL:
    """The built CUDA-core kernel library (nvcc runs here on first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load(_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mde_bins_head_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.mde_bins_head_fwd.restype = i32
        lib.mde_bins_head_bwd.argtypes = [ptr] * 12 + [i32] * 5 + [ptr]
        lib.mde_bins_head_bwd.restype = i32
        lib.mde_bins_head_bwd_pixels_per_block.argtypes = []
        lib.mde_bins_head_bwd_pixels_per_block.restype = i32
        lib.mde_bins_head_bwd_weight_blocks.argtypes = [i32] * 4
        lib.mde_bins_head_bwd_weight_blocks.restype = i32
        lib.mde_cuda_error_string.argtypes = [i32]
        lib.mde_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def tc_library() -> ctypes.CDLL:
    """The built tensor-core kernel library (nvcc runs here on first use)."""
    global _TC_LIB
    if _TC_LIB is None:
        lib = build.load(_TC_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mde_bins_head_tc_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.mde_bins_head_tc_fwd.restype = i32
        lib.mde_bins_head_tc_bwd.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
        lib.mde_bins_head_tc_bwd.restype = i32
        lib.mde_bins_head_tc_weight_blocks.argtypes = [i32] * 4
        lib.mde_bins_head_tc_weight_blocks.restype = i32
        lib.mde_cuda_error_string.argtypes = [i32]
        lib.mde_cuda_error_string.restype = ctypes.c_char_p
        _TC_LIB = lib
    return _TC_LIB


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.mde_cuda_error_string(err).decode())


def _launch(x, weight, bias, centers, stats=False):
    """The float32 forward; returns the depth (B, 1, H, W) and, where
    `stats`, each pixel's softmax (max, sum) as (2, B, H*W), else None."""
    global LAUNCHES
    lib = library()
    b, _, h, w = x.shape
    out = torch.empty((b, 1, h, w), dtype=torch.float32, device=x.device)
    saved = torch.empty((2, b, h * w), dtype=torch.float32, device=x.device) if stats else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mde_bins_head_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), centers.data_ptr(),
        out.data_ptr(), saved.data_ptr() if stats else None, b, h * w, weight.shape[0],
        x.device.index, stream)
    _raise_on(lib, err, "bins-head")
    LAUNCHES += 1
    return out, saved


def _launch_bwd(x, weight, bias, centers, grad, out, stats):
    """The float32 backward kernels, from the forward's depth and stats;
    returns (dx, dW (n_bins, 128), db, dcenters) with the per-block partials
    folded in a fixed order. The pixel kernel hands dlog to the weight
    kernel through a (B, n_bins, H*W rounded up to 128) float32 scratch
    buffer: 927 MB at the flagship shape (16 x 208 x 272, 256 bins)."""
    global BWD_LAUNCHES
    lib = library()
    b, _, h, w = x.shape
    hw, n = h * w, weight.shape[0]
    g = grad.float().contiguous()
    px_per_block = lib.mde_bins_head_bwd_pixels_per_block()
    blocks = -(-hw // px_per_block)
    dw_blocks = lib.mde_bins_head_bwd_weight_blocks(b, hw, n, x.device.index)
    if dw_blocks <= 0:
        raise RuntimeError("bins-head backward: no launch shape for the weight kernel "
                           "on this device")
    dx = torch.empty_like(x)
    dlog = torch.empty((b, n, blocks * px_per_block), dtype=torch.float32, device=x.device)
    part_dbc = torch.empty((2, b, blocks, n), dtype=torch.float32, device=x.device)
    part_dw = torch.empty((dw_blocks, n, _CHANNELS), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mde_bins_head_bwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), centers.data_ptr(),
        g.data_ptr(), out.data_ptr(), stats.data_ptr(), dx.data_ptr(), dlog.data_ptr(),
        part_dbc[0].data_ptr(), part_dbc[1].data_ptr(), part_dw.data_ptr(), dw_blocks,
        b, hw, n, x.device.index, stream)
    _raise_on(lib, err, "bins-head backward")
    BWD_LAUNCHES += 2
    return dx, part_dw.sum(dim=0), part_dbc[0].sum(dim=(0, 1)), part_dbc[1].sum(dim=1)


def _vec(x, hw):
    """Whether the tensor-core kernels may move x in 16-byte rows: hw % 8 == 0
    and x 16-byte aligned (else they go element by element)."""
    return int(hw % 8 == 0 and x.data_ptr() % 16 == 0)


def _launch_tc(x, weight, bias, centers):
    """The bf16 tensor-core forward; returns the depth (B, 1, H, W) and each
    pixel's softmax (max, sum) as (2, B, H*W), which its backward reads."""
    global TC_LAUNCHES
    lib = tc_library()
    b, _, h, w = x.shape
    hw = h * w
    out = torch.empty((b, 1, h, w), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, b, hw), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mde_bins_head_tc_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), centers.data_ptr(),
        out.data_ptr(), stats.data_ptr(), b, hw, weight.shape[0], _vec(x, hw),
        x.device.index, stream)
    _raise_on(lib, err, "bins-head tensor-core")
    TC_LAUNCHES += 1
    return out, stats


def _launch_tc_bwd(x, weight, bias, centers, grad, out, stats):
    """The bf16 tensor-core backward kernels, from the forward's depth and
    stats; returns (dx, dW (n_bins, 128), db, dcenters), partials folded."""
    global TC_BWD_LAUNCHES
    lib = tc_library()
    b, _, h, w = x.shape
    hw, n = h * w, weight.shape[0]
    g = grad.float().contiguous()
    blocks = lib.mde_bins_head_tc_weight_blocks(b, hw, n, x.device.index)
    if blocks <= 0:
        raise RuntimeError("bins-head tensor-core backward: no launch shape for the "
                           "weight kernel on this device")
    dx = torch.empty_like(x)
    part_dw = torch.empty((blocks, n, _CHANNELS), dtype=torch.float32, device=x.device)
    part_db = torch.empty((blocks, n), dtype=torch.float32, device=x.device)
    part_dc = torch.zeros((blocks, b, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mde_bins_head_tc_bwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), centers.data_ptr(),
        g.data_ptr(), out.data_ptr(), stats.data_ptr(), dx.data_ptr(),
        part_dw.data_ptr(), part_db.data_ptr(), part_dc.data_ptr(), blocks, b, hw, n,
        _vec(x, hw), x.device.index, stream)
    _raise_on(lib, err, "bins-head tensor-core backward")
    TC_BWD_LAUNCHES += 2
    return dx, part_dw.sum(dim=0), part_db.sum(dim=0), part_dc.sum(dim=0)
