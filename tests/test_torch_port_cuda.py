"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where there is no NVIDIA card (a
CUDA kernel has no CPU mode). The file imports no JAX, so it runs on a machine
with the card but without JAX, where tests/conftest.py cannot load:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

float32 features go to the CUDA-core kernels (csrc/bins_head.cu), bfloat16
features to the tensor-core kernels (csrc/bins_head_tc.cu); each family has
its own launch counters. float32 comparisons run with TF32 off. Forward
tolerances are those of tests/test_kernels.py: rtol/atol 1e-5 in float32,
2e-2 in bfloat16.
Gradients are compared by their largest error against the largest reference
value of the tensor: 1e-4 in float32 (dW and db are sums over up to 150k
pixels, taken by the kernel in per-block partials and by autograd in another
order) and, in bfloat16 (the same rounding points, other orders), 2e-2 for
dx and dcenters and 1e-3 for dW and db (`GRAD_TOL`).
The chamfer value and centre gradient are held at rtol 1e-5 / 1e-4, as
tests/test_kernels.py holds the Pallas kernel.
"""

import pytest
import torch

from mde_tpu_torch.kernels import bins_head, chamfer
from mde_tpu_torch.ops.losses import bins_chamfer_loss

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Per gradient. bf16 dW and db are f32 sums on both sides, as in the JAX
# kernel; what is left is the odd logit whose f32 sum rounds to the other
# bf16 neighbour in the kernel's order than in the plain head's: at most
# 5.1e-4 (dW) and 4.0e-4 (db) of the largest value over these shapes on an
# H100 (2.0e-3 and 3.2e-3 at the flagship shape while the plain head rounded
# them to bf16).
GRAD_TOL = {torch.float32: dict.fromkeys(("dx", "dW", "db", "dcenters"), 1e-4),
            torch.bfloat16: {"dx": 2e-2, "dW": 1e-3, "db": 1e-3, "dcenters": 2e-2}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _head_inputs(device, dtype, b, h, w, n, seed=3, misaligned=False):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 128, h, w), generator=gen).to(device, dtype)
    if misaligned:  # contiguous, but one element past a 16-byte boundary
        x = torch.empty(x.numel() + 1, dtype=dtype, device=device)[1:].view(x.shape).copy_(x)
    weight = (0.1 * torch.randn((n, 128, 1, 1), generator=gen)).to(device)
    bias = (0.1 * torch.randn((n,), generator=gen)).to(device)
    centers = (10 * torch.rand((b, n), generator=gen)).sort(dim=1).values.to(device)
    return x, weight, bias, centers


def _fwd_count(dtype):
    return bins_head.TC_LAUNCHES if dtype == torch.bfloat16 else bins_head.LAUNCHES


def _bwd_count(dtype):
    return bins_head.TC_BWD_LAUNCHES if dtype == torch.bfloat16 else bins_head.BWD_LAUNCHES


# bf16 moves features in 16-byte rows only where hw % 8 == 0 (24 here, half
# a 16-pixel unit), else element by element (63, 65, 1617); it keeps W
# resident in shared memory up to 640 bins and stages it in chunks above
# that (896 and 1024 bins here)
HEAD_SHAPES = [(2, 8, 16, 128), (2, 240, 320, 256), (1, 7, 9, 256), (3, 33, 49, 384),
               (2, 5, 13, 128), (2, 4, 6, 256), (16, 208, 272, 256), (2, 24, 40, 512),
               (1, 7, 9, 896), (2, 12, 20, 1024)]
HEAD_IDS = ["small", "serving", "ragged63", "ragged1617_384", "ragged65", "hw24", "flagship",
            "bins512", "ragged63_896", "bins1024"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,n", HEAD_SHAPES, ids=HEAD_IDS)
def test_bins_head_kernel_matches_plain(cuda, dtype, b, h, w, n):
    """Includes ragged pixel counts (24, 63, 65, 1617), which the kernels
    mask, the flagship training shape and 512 to 1024 bins."""
    args = _head_inputs(cuda, dtype, b, h, w, n)
    want = bins_head.fused_bins_head_reference(*args)
    before = _fwd_count(dtype)
    got = bins_head.fused_bins_head(*args)
    torch.cuda.synchronize()
    assert _fwd_count(dtype) == before + 1
    assert got.shape == (b, 1, h, w) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def _head_grads(fn, args, upstream):
    inputs = [t.detach().clone().requires_grad_() for t in args]
    out = fn(*inputs)
    return out, torch.autograd.grad(out, inputs, upstream)


def _assert_grad_close(got, want, tol, name):
    scale = want.float().abs().max().clamp(min=1e-30)
    err = (got.float() - want.float()).abs().max()
    assert err <= tol * scale, f"{name}: max error {err:.3e} against scale {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,n", HEAD_SHAPES, ids=HEAD_IDS)
def test_bins_head_backward_kernel_matches_plain(cuda, dtype, b, h, w, n):
    """dx, dW, db and dcenters of the backward kernels against autograd
    through the plain version; ragged pixel counts (24, 63, 65, 1617), the
    flagship training shape and 512 to 1024 bins included."""
    args = _head_inputs(cuda, dtype, b, h, w, n)
    upstream = torch.randn((b, 1, h, w), generator=torch.Generator().manual_seed(5)).to(cuda)
    _, want = _head_grads(bins_head.fused_bins_head_reference, args, upstream)
    before = _bwd_count(dtype)
    _, got = _head_grads(bins_head.fused_bins_head, args, upstream)
    torch.cuda.synchronize()
    assert _bwd_count(dtype) == before + 2  # the pixel and the weight kernel
    for name, g, r, t in zip(("dx", "dW", "db", "dcenters"), got, want, args):
        assert g.shape == t.shape and g.dtype == t.dtype, name
        _assert_grad_close(g, r, GRAD_TOL[dtype][name], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bins_head_bf16_kernels_take_misaligned_features(cuda, dtype):
    """hw is a multiple of 8, but the features start one element (4 bytes in
    f32, 2 in bf16) off a 16-byte boundary: the float32 forward and the
    tensor-core kernels then load them element by element."""
    b, h, w, n = 2, 16, 24, 128
    args = _head_inputs(cuda, dtype, b, h, w, n, misaligned=True)
    assert args[0].data_ptr() % 16 != 0
    upstream = torch.randn((b, 1, h, w), generator=torch.Generator().manual_seed(8)).to(cuda)
    want_out, want = _head_grads(bins_head.fused_bins_head_reference, args, upstream)
    got_out, got = _head_grads(bins_head.fused_bins_head, args, upstream)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_out, want_out, rtol=TOL[dtype], atol=TOL[dtype])
    for name, g, r in zip(("dx", "dW", "db", "dcenters"), got, want):
        _assert_grad_close(g, r, GRAD_TOL[dtype][name], name)


@pytest.mark.cuda
def test_bins_head_f32_forward_peaked_softmax(cuda):
    """W scaled so that the logits span about +-60: each pixel's softmax
    sits on a few bins, so the running maxima that the float32 forward
    merges across its threads and its three 128-bin chunks differ by tens,
    and a wrong rescale shows. Features, W and b lie on a 1/8 grid, so every
    logit is exact in float32 whatever the order of its sum, and the 1e-5
    holds the softmax alone (with random values, logits this large put the
    plain head 5e-5 off a float64 one). 960 pixels, not a multiple of the
    128-pixel tile."""
    x, weight, bias, centers = _head_inputs(cuda, torch.float32, 2, 24, 40, 384)
    grid = lambda t: (8 * t).round() / 8
    x, weight, bias = grid(x), grid(12 * weight), grid(bias)  # W of std 1.2
    logits = torch.einsum("bchw,nc->bnhw", x, weight.reshape(384, 128)) + bias[:, None, None]
    assert 45 < logits.abs().max().item() < 90
    want = bins_head.fused_bins_head_reference(x, weight, bias, centers)
    got = bins_head.fused_bins_head(x, weight, bias, centers)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32], atol=TOL[torch.float32])


@pytest.mark.cuda
def test_bins_head_dtype_picks_kernel_family(cuda):
    """float32 features launch the CUDA-core kernels and only those,
    bfloat16 features the tensor-core kernels and only those."""
    for dtype in (torch.float32, torch.bfloat16):
        inputs = [t.requires_grad_() for t in _head_inputs(cuda, dtype, 2, 16, 24, 128)]
        before = (bins_head.LAUNCHES, bins_head.BWD_LAUNCHES, bins_head.TC_LAUNCHES,
                  bins_head.TC_BWD_LAUNCHES)
        bins_head.fused_bins_head(*inputs).sum().backward()
        torch.cuda.synchronize()
        after = (bins_head.LAUNCHES, bins_head.BWD_LAUNCHES, bins_head.TC_LAUNCHES,
                 bins_head.TC_BWD_LAUNCHES)
        step = (0, 0, 1, 2) if dtype == torch.bfloat16 else (1, 2, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == step, dtype


@pytest.mark.cuda
def test_bins_head_backward_reached_through_loss_backward(cuda):
    """loss.backward() through the kernel gives autograd's gradients through
    the plain version, for all four inputs."""
    args = _head_inputs(cuda, torch.float32, 2, 16, 24, 128)
    target = torch.rand((2, 1, 16, 24), generator=torch.Generator().manual_seed(6)).to(cuda)
    grads = []
    for fn in (bins_head.fused_bins_head_reference, bins_head.fused_bins_head):
        inputs = [t.detach().clone().requires_grad_() for t in args]
        ((fn(*inputs) - 5 * target) ** 2).mean().backward()
        grads.append([t.grad for t in inputs])
    for name, g, r in zip(("dx", "dW", "db", "dcenters"), grads[1], grads[0]):
        _assert_grad_close(g, r, GRAD_TOL[torch.float32][name], name)


@pytest.mark.cuda
def test_bins_head_under_autocast_keeps_dtypes(cuda):
    """Under autocast(bfloat16) with requires_grad: bf16 features go in as
    they are, the output is f32, and the gradients come back in each input's
    dtype and agree with the plain version."""
    x, weight, bias, centers = _head_inputs(cuda, torch.bfloat16, 2, 16, 24, 256)
    inputs = [t.detach().clone().requires_grad_() for t in (x, weight, bias, centers)]
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = bins_head.fused_bins_head(*inputs)
        want = bins_head.fused_bins_head_reference(x, weight, bias, centers)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    out.sum().backward()
    _, ref = _head_grads(bins_head.fused_bins_head_reference, (x, weight, bias, centers),
                         torch.ones_like(out))
    for name, t, r in zip(("dx", "dW", "db", "dcenters"), inputs, ref):
        assert t.grad.dtype == t.dtype, name
        _assert_grad_close(t.grad, r, GRAD_TOL[torch.bfloat16][name], name)


def _chamfer_inputs(device, b, hw, p, seed=7):
    gen = torch.Generator().manual_seed(seed)
    widths = torch.rand((b, p), generator=gen) + 0.05
    edges = torch.cumsum(torch.cat([torch.full((b, 1), 1e-3),
                                    (10 - 1e-3) * widths / widths.sum(1, keepdim=True)], 1), 1)
    depth = 10 * torch.rand((b, 1, *hw), generator=gen)
    depth[depth < 0.4] = 0.0
    return edges.to(device), depth.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,p", [(2, (24, 32), 16), (3, (33, 49), 256),
                                    (2, (416, 544), 256), (1, (7, 9), 256)])
def test_chamfer_kernel_reductions_match_plain(cuda, b, hw, p):
    """The five outputs, on tie-free random depths; ragged pixel counts
    (1617, 63) and more than one tile (226,304 pixels) included."""
    edges, depth = _chamfer_inputs(cuda, b, hw, p)
    centers = 0.5 * (edges[:, 1:] + edges[:, :-1])
    flat = depth.reshape(b, -1)
    want = chamfer.chamfer_reductions_reference(centers, flat)
    before = chamfer.LAUNCHES
    got = chamfer.chamfer_reductions(centers, flat)
    torch.cuda.synchronize()
    assert chamfer.LAUNCHES == before + 1
    for name, g, r in zip(("min", "nearest", "count", "depth_sum", "y_min"), got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "all_invalid_image", "mixed_valid_counts"])
def test_chamfer_kernel_loss_and_gradient_match_plain(cuda, case):
    """1617 pixels (not a multiple of the tile); an image with no valid
    depth; images with different valid counts."""
    edges, depth = _chamfer_inputs(cuda, 3, (33, 49), 256, seed=11)
    if case == "all_invalid_image":
        depth[1] = 0.0
    elif case == "mixed_valid_counts":
        depth[0, :, :10] = 0.0
        depth[2, :, :, 5:] = 0.0
    e = edges.detach().clone().requires_grad_()
    value = chamfer.chamfer_1d(e, depth)
    value.backward()
    # the plain reductions run for CPU tensors, with the kernel's tie rule
    e_cpu = edges.cpu().requires_grad_()
    want = chamfer.chamfer_1d(e_cpu, depth.cpu())
    want.backward()
    torch.testing.assert_close(value.cpu(), want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(value, bins_chamfer_loss(edges, depth), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(e.grad.cpu(), e_cpu.grad, rtol=1e-4, atol=1e-6)
    if case == "all_invalid_image":
        assert torch.all(e.grad[1] == 0)


@pytest.mark.cuda
def test_bins_head_kernel_refuses_non_contiguous(cuda):
    x, weight, bias, centers = _head_inputs(cuda, torch.float32, 1, 16, 8, 128)
    with pytest.raises(ValueError, match="contiguous"):
        bins_head.fused_bins_head(x.transpose(2, 3), weight, bias, centers)
