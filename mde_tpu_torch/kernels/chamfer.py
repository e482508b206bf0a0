"""Bins-chamfer loss through the chamfer-reductions kernel, port of
`mde_tpu/kernels/chamfer.py`.

`chamfer_reductions` launches the hand-written CUDA kernel `csrc/chamfer.cu`
for CUDA tensors; it replaces the Pallas TPU kernel `_chamfer_kernel`. For
CPU tensors it runs `chamfer_reductions_reference`, the plain PyTorch version
with the same outputs. There is no fallback between the two: a CUDA tensor the
kernel cannot take raises. Up to 256 bins `chamfer_kernel` keeps each lane's
bins in registers (4 or 8 a lane) and forms each (bin, pixel) distance once
for both reductions; from 257 to `_MAX_BINS` bins `chamfer_wide_kernel` walks
the same way over groups of 256 bins, each distance formed once, and names
each pixel's bin after the last group. Both write per-tile partials
(`mde_chamfer_tile_pixels(p)` pixels a tile), which `_launch` folds; each
counts its launches (`LAUNCHES`, `WIDE_LAUNCHES`).

`ChamferFromCenters` is an autograd.Function over those reductions: its
forward forms the loss (`_chamfer_fwd`, chamfer.py:171-186) and its backward
the analytic gradient to the centres (`_chamfer_bwd`, :189-199), both small
torch ops on the (batch, bins) reductions. The GT depth gets no gradient.

    loss = mean_i[mean_b min_per_bin] + mean_i[sum_y / cnt]
    dloss/dc_b = 2 (c_b - nearest_b) / (P N) + 2 (cnt_b c_b - sumd_b) / (cnt N)

An image with no valid pixel adds 0 to the loss and gets a zero gradient.
Ties: the nearest depth of a bin is that of the lowest pixel index among the
minima (the JAX kernel picks by lane; ROADMAP §3 "Chamfer tie semantics").
"""

import ctypes

import torch

from ..ops.bins import bin_centers
from . import build

_BIG = 3.4e38  # "no valid pixel", as in mde_tpu/kernels/chamfer.py
_SOURCE = "chamfer.cu"
_REGISTER_BINS = 256  # up to here chamfer_kernel, above it chamfer_wide_kernel
_MAX_BINS = 2048  # the wide kernel keeps four floats a bin in shared memory beside
                  # 8 bytes a pixel of its sub-tile: 74 KB a block at 2,048 bins
_LIB = None

# Kernel launches since the last reset, chamfer_kernel's and
# chamfer_wide_kernel's; only the CUDA path adds to them.
LAUNCHES = 0
WIDE_LAUNCHES = 0


def chamfer_reductions_reference(centers: torch.Tensor, depth: torch.Tensor,
                                 valid_threshold: float = 1e-3, chunk: int = 8192):
    """Plain version of the kernel. centers (N, P) f32, depth (N, M) f32 ->
    (min_per_bin, nearest_depth, count_per_bin, depth_sum_per_bin) each
    (N, P), and y_min (N, M), 0 where the depth is not valid."""
    n, p = centers.shape
    valid = depth >= valid_threshold
    min_pb = torch.full_like(centers, _BIG)
    near = torch.zeros_like(centers)
    cnt_pb = torch.zeros_like(centers)
    sumd_pb = torch.zeros_like(centers)
    y_min = torch.zeros_like(depth)
    for start in range(0, depth.shape[1], chunk):
        dc, vc = depth[:, start:start + chunk], valid[:, start:start + chunk]
        diff = centers[:, None, :] - dc[:, :, None]                 # (N, K, P)
        d2 = diff * diff
        y = d2.amin(dim=2)
        y_min[:, start:start + chunk] = torch.where(vc, y, torch.zeros_like(y))
        at = (d2 == y[..., None]).float()
        at = at / at.sum(dim=2, keepdim=True).clamp(min=1.0) * vc[..., None]
        cnt_pb += at.sum(dim=1)
        sumd_pb += (at * dc[..., None]).sum(dim=1)
        masked = torch.where(vc[..., None], d2, torch.full_like(d2, _BIG))
        first = masked.argmin(dim=1)                                # (N, P)
        best = masked.gather(1, first[:, None, :])[:, 0]
        better = best < min_pb
        min_pb = torch.where(better, best, min_pb)
        near = torch.where(better, dc.gather(1, first), near)
    return min_pb, near, cnt_pb, sumd_pb, y_min


def chamfer_reductions(centers: torch.Tensor, depth: torch.Tensor,
                       valid_threshold: float = 1e-3):
    """The reductions of `chamfer_reductions_reference`, through the kernel
    for CUDA tensors and the plain version for CPU tensors."""
    if centers.dim() != 2 or depth.dim() != 2 or depth.shape[0] != centers.shape[0]:
        raise ValueError(f"expected centers (N, P) and depth (N, M), got "
                         f"{tuple(centers.shape)} and {tuple(depth.shape)}")
    for name, t in (("centers", centers), ("depth", depth)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if depth.device != centers.device:
        raise ValueError(f"depth is on {depth.device}, centers on {centers.device}")
    if centers.device.type == "cpu":
        return chamfer_reductions_reference(centers, depth, valid_threshold)
    if centers.device.type != "cuda":
        raise ValueError(f"no chamfer kernel for device {centers.device}")
    if centers.shape[1] > _MAX_BINS:
        raise ValueError(f"the chamfer kernel takes at most {_MAX_BINS} bins, "
                         f"got {centers.shape[1]}")
    return _launch(centers.contiguous(), depth.contiguous(), float(valid_threshold))


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc runs here on first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load(_SOURCE)
        lib.mde_chamfer_tile_pixels.argtypes = [ctypes.c_int]
        lib.mde_chamfer_tile_pixels.restype = ctypes.c_int
        lib.mde_chamfer_reductions.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.mde_chamfer_reductions.restype = ctypes.c_int
        lib.mde_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mde_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(centers, depth, valid_threshold):
    global LAUNCHES, WIDE_LAUNCHES
    lib = library()
    n, p = centers.shape
    m = depth.shape[1]
    tile = lib.mde_chamfer_tile_pixels(p)
    tiles = -(-m // tile)
    parts = torch.empty((4, n, tiles, p), dtype=torch.float32, device=centers.device)
    y_min = torch.empty_like(depth)
    stream = torch.cuda.current_stream(centers.device).cuda_stream
    err = lib.mde_chamfer_reductions(
        centers.data_ptr(), depth.data_ptr(), n, m, p, valid_threshold,
        parts[0].data_ptr(), parts[1].data_ptr(), parts[2].data_ptr(),
        parts[3].data_ptr(), y_min.data_ptr(), centers.device.index, stream)
    if err != 0:
        raise RuntimeError("chamfer kernel launch failed: "
                           + lib.mde_cuda_error_string(err).decode())
    if p > _REGISTER_BINS:
        WIDE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    part_min, part_near, part_cnt, part_sumd = parts
    # fold the tiles: the smallest distance wins, then the lowest tile
    first = part_min.argmin(dim=1, keepdim=True)                    # (N, 1, P)
    min_pb = part_min.gather(1, first)[:, 0]
    near = part_near.gather(1, first)[:, 0]
    return min_pb, near, part_cnt.sum(dim=1), part_sumd.sum(dim=1), y_min


class ChamferFromCenters(torch.autograd.Function):
    """Bins-chamfer loss of (N, P) centres against (N, M) GT depths, with the
    analytic gradient to the centres."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, centers, depth, valid_threshold):
        centers = centers.float()
        depth = depth.float()
        min_pb, near, cnt_pb, sumd_pb, y_min = chamfer_reductions(
            centers, depth, valid_threshold)
        cnt = (depth >= valid_threshold).float().sum(dim=1)
        has_valid = cnt > 0
        zero = torch.zeros_like(cnt)
        cham_x = torch.where(min_pb >= _BIG, torch.zeros_like(min_pb), min_pb).mean(dim=1)
        cham_x = torch.where(has_valid, cham_x, zero)
        cham_y = torch.where(has_valid, y_min.sum(dim=1) / cnt.clamp(min=1.0), zero)
        ctx.save_for_backward(centers, min_pb, near, cnt_pb, sumd_pb, cnt)
        return cham_x.mean() + cham_y.mean()

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        centers, min_pb, near, cnt_pb, sumd_pb, cnt = ctx.saved_tensors
        n, p = centers.shape
        has_valid = (cnt > 0).float()[:, None]
        bin_hit = (min_pb < _BIG).float()
        gx = 2.0 * (centers - near) * bin_hit / p
        gy = 2.0 * (cnt_pb * centers - sumd_pb) / cnt.clamp(min=1.0)[:, None]
        return (gx + gy) * has_valid / n * g, None, None


def chamfer_1d(bin_edges: torch.Tensor, target_depth: torch.Tensor,
               valid_threshold: float = 1e-3) -> torch.Tensor:
    """Drop-in for ops.losses.bins_chamfer_loss through the reductions kernel
    (the entry `chamfer_1d_pallas` of the JAX package): bin_edges (N, P + 1),
    target_depth (N, 1, H, W). Differentiable with respect to bin_edges,
    through the centres."""
    depth = target_depth.reshape(target_depth.shape[0], -1)
    return ChamferFromCenters.apply(bin_centers(bin_edges.float()), depth, valid_threshold)
