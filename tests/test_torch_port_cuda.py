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
value of the tensor: 1e-4 in float32 and, in bfloat16 (the same rounding
points, other orders), 2e-2 for dx and dcenters and 1e-3 for dW and db
(`GRAD_TOL`). float32 stays at 1e-4 because its sums are long and taken in
another order than autograd's: dW and db sum up to 905k pixels (per tile,
per block, then over the blocks), dx sums the bins in 128-bin chunks, and p
comes from the forward's saved softmax (max, sum), whose sum is itself
merged across 16 threads; each of these moves an f32 sum by ~1e-6 of its
largest term. The float32 backward is deterministic: two calls give the same
bits (no float atomics; the partials are folded in a fixed order).
The chamfer value and centre gradient are held at rtol 1e-5 / 1e-4, as
tests/test_kernels.py holds the Pallas kernel. The chamfer reductions are
held at rtol 1e-5, atol 1e-6: min, nearest depth and y_min are the same
float32 squared distances picked by the same rule, and count and depth sum
are float32 sums taken in another order (the kernel sums runs of pixels,
then by shared-memory atomics in a block, then over tiles). On exact dyadic inputs every squared distance and every count (sums
of 1 and 1/2) is exact in float32, so there min, nearest, count and y_min
must be equal (rtol = atol = 0) and only the depth sum keeps 1e-5.
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
    flagship training shape and 512 to 1024 bins included. The forward runs
    first and saves each pixel's softmax (max, sum), which the backward
    reads (both families)."""
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
    f32, 2 in bf16) off a 16-byte boundary: the forward and both backward
    kernels of each family then load them element by element (the float32
    backward still stores dx, its own allocation, in 16-byte rows). Then 63
    pixels, where neither the pointer nor hw allows 16-byte rows."""
    for b, h, w, n in ((2, 16, 24, 128), (1, 7, 9, 256)):
        args = _head_inputs(cuda, dtype, b, h, w, n, misaligned=True)
        assert args[0].data_ptr() % 16 != 0
        upstream = torch.randn((b, 1, h, w), generator=torch.Generator().manual_seed(8)).to(cuda)
        want_out, want = _head_grads(bins_head.fused_bins_head_reference, args, upstream)
        before = _bwd_count(dtype)
        got_out, got = _head_grads(bins_head.fused_bins_head, args, upstream)
        torch.cuda.synchronize()
        assert _bwd_count(dtype) == before + 2
        torch.testing.assert_close(got_out, want_out, rtol=TOL[dtype], atol=TOL[dtype])
        for name, g, r in zip(("dx", "dW", "db", "dcenters"), got, want):
            _assert_grad_close(g, r, GRAD_TOL[dtype][name], (b, h, w, n, name))


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
    x, weight, bias, centers = _peaked_inputs(cuda)  # W of std 1.2
    logits = torch.einsum("bchw,nc->bnhw", x, weight.reshape(384, 128)) + bias[:, None, None]
    assert 45 < logits.abs().max().item() < 90
    want = bins_head.fused_bins_head_reference(x, weight, bias, centers)
    got = bins_head.fused_bins_head(x, weight, bias, centers)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32], atol=TOL[torch.float32])


def _peaked_inputs(device):
    """Features, W and b on a 1/8 grid, W of std 1.2: logits span about
    +-60 and are exact in float32 whatever the order of their sums."""
    x, weight, bias, centers = _head_inputs(device, torch.float32, 2, 24, 40, 384)
    grid = lambda t: (8 * t).round() / 8
    return grid(x), grid(12 * weight), grid(bias), centers


@pytest.mark.cuda
def test_bins_head_f32_backward_peaked_softmax(cuda):
    """The float32 backward on the inputs of the peaked-softmax forward
    test: each pixel's p sits on a few bins, so p = exp(logit - max) / sum
    from the forward's saved (max, sum) is wrong by orders of magnitude if
    the saved max is not the true one, and the logits the backward forms
    again must be the forward's. 960 pixels: ragged against 128-pixel blocks
    and 64-pixel tiles."""
    args = _peaked_inputs(cuda)
    upstream = torch.randn((2, 1, 24, 40), generator=torch.Generator().manual_seed(9)).to(cuda)
    want_out, want = _head_grads(bins_head.fused_bins_head_reference, args, upstream)
    got_out, got = _head_grads(bins_head.fused_bins_head, args, upstream)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_out, want_out, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    for name, g, r in zip(("dx", "dW", "db", "dcenters"), got, want):
        _assert_grad_close(g, r, GRAD_TOL[torch.float32][name], name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,n", HEAD_SHAPES, ids=HEAD_IDS)
def test_bins_head_f32_forward_saves_softmax_stats(cuda, b, h, w, n):
    """The float32 forward's saved (max, sum) per pixel against the plain
    logits' max and sum of exp(logit - max), at rtol 1e-5 (float64 plain
    logits: the kernel's f32 sums differ from them by ~1e-6 relative)."""
    x, weight, bias, centers = _head_inputs(cuda, torch.float32, b, h, w, n)
    out, stats = bins_head._launch(x, weight, bias, centers, stats=True)
    torch.cuda.synchronize()
    logits = torch.einsum("bcp,nc->bnp", x.double().reshape(b, 128, h * w),
                          weight.double().reshape(n, 128)) + bias.double()[:, None]
    m = logits.amax(dim=1)
    s = torch.exp(logits - m[:, None]).sum(dim=1)
    assert stats.shape == (2, b, h * w) and stats.dtype == torch.float32
    torch.testing.assert_close(stats[0].double(), m, rtol=1e-5, atol=0)
    torch.testing.assert_close(stats[1].double(), s, rtol=1e-5, atol=0)
    torch.testing.assert_close(out, bins_head.fused_bins_head_reference(x, weight, bias, centers),
                               rtol=TOL[torch.float32], atol=TOL[torch.float32])


@pytest.mark.cuda
def test_bins_head_f32_forward_saves_stats_only_before_a_backward(cuda, monkeypatch):
    """Under torch.inference_mode() (as InferenceHelper.predict), under
    no_grad and with no input that requires a gradient, the float32 forward
    is asked for no stats; with one, it is."""
    asked = []
    launch = bins_head._launch

    def spy(*args, stats=False):
        asked.append(stats)
        out, saved = launch(*args, stats=stats)
        assert (saved is not None) == stats
        return out, saved

    monkeypatch.setattr(bins_head, "_launch", spy)
    args = _head_inputs(cuda, torch.float32, 2, 16, 24, 128)
    with torch.inference_mode():
        bins_head.fused_bins_head(*args)
    with torch.no_grad():
        bins_head.fused_bins_head(args[0], args[1].clone().requires_grad_(), *args[2:])
    bins_head.fused_bins_head(*args)
    bins_head.fused_bins_head(args[0].clone().requires_grad_(), *args[1:]).sum().backward()
    torch.cuda.synchronize()
    assert asked == [False, False, False, True]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,n", [(3, 33, 49, 384), (16, 208, 272, 256)],
                         ids=["ragged1617_384", "flagship"])
def test_bins_head_backward_is_deterministic(cuda, dtype, b, h, w, n):
    """Two backward calls on the same inputs give the same bits in all four
    gradients: no float atomics, partials folded in a fixed order."""
    args = _head_inputs(cuda, dtype, b, h, w, n)
    upstream = torch.randn((b, 1, h, w), generator=torch.Generator().manual_seed(4)).to(cuda)
    _, first = _head_grads(bins_head.fused_bins_head, args, upstream)
    _, second = _head_grads(bins_head.fused_bins_head, args, upstream)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "dW", "db", "dcenters"), first, second):
        assert torch.equal(a, r), name


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


def _assert_reductions_match_plain(centers, flat, exact=False):
    """The kernel's five outputs against the plain version's: exact where
    `exact` (all but the depth sum), else at rtol 1e-5, atol 1e-6."""
    want = chamfer.chamfer_reductions_reference(centers.cpu(), flat.cpu())
    before = chamfer.LAUNCHES
    got = chamfer.chamfer_reductions(centers, flat)
    torch.cuda.synchronize()
    assert chamfer.LAUNCHES == before + 1
    for name, g, r in zip(("min", "nearest", "count", "depth_sum", "y_min"), got, want):
        tol = (0.0, 0.0) if exact and name != "depth_sum" else (1e-5, 1e-6)
        torch.testing.assert_close(g.cpu(), r, rtol=tol[0], atol=tol[1], msg=name)
    return [g.cpu() for g in got]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,p", [(2, (24, 32), 16), (3, (33, 49), 256),
                                    (2, (416, 544), 256), (1, (7, 9), 256),
                                    (2, (24, 32), 1), (3, (33, 49), 33),
                                    (2, (64, 80), 257), (1, (24, 40), 2048)])
def test_chamfer_kernel_reductions_match_plain(cuda, b, hw, p):
    """The five outputs, on tie-free random depths; ragged pixel counts
    (1617, 63) and more than one tile (226,304 pixels) included; 1, 16 and
    33 bins leave lanes and bins of a lane padded; 257 (two tiles of 5,120
    pixels) and 2,048 bins take the kernel for more than 256 bins."""
    edges, depth = _chamfer_inputs(cuda, b, hw, p)
    centers = 0.5 * (edges[:, 1:] + edges[:, :-1])
    _assert_reductions_match_plain(centers, depth.reshape(b, -1))


def smooth_depth(b, h, w, seed):
    """A tilted plane per image from 0.5 to 9.5 m, in whole millimetres (as
    NYU's ground truth, stored in mm), with a block of invalid zeros: many
    neighbouring pixels share a depth and a nearest bin."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand((b, 1, 1), generator=gen)
    y = torch.linspace(0, 1, h)[None, :, None]
    x = torch.linspace(0, 1, w)[None, None, :]
    depth = torch.round(1000 * (0.5 + 9.0 * (a * x + (1 - a) * y))) / 1000
    depth[:, h // 4:h // 4 + 64, w // 3:w // 3 + 128] = 0.0
    return depth[:, None]


@pytest.mark.cuda
def test_chamfer_kernel_smooth_millimetre_depth_matches_plain(cuda):
    """The flagship shape (16 x 416x544, 256 bins) on smooth mm-quantized
    planes with a block of invalid zeros."""
    edges, _ = _chamfer_inputs(cuda, 16, (8, 8), 256, seed=9)
    centers = 0.5 * (edges[:, 1:] + edges[:, :-1])
    depth = smooth_depth(16, 416, 544, seed=10).to(cuda)
    got = _assert_reductions_match_plain(centers, depth.reshape(16, -1))
    assert (got[4] == 0).any() and (got[2] > 100).any()  # invalid block; shared bins


@pytest.mark.cuda
def test_chamfer_kernel_exact_ties_match_plain(cuda):
    """Dyadic inputs with exact ties, equal to the plain version bit for bit
    (depth sum at 1e-5). Centres 1 + k/2 (k < 256) in a seeded order, so
    that some bins of equal spacing share a lane (bins b and b + 32k) and
    others do not. Images 0 and 1: only pairs of depths c - 1/16 and
    c + 1/16 around 24 bins, the pair in one tile half a tile apart (two
    warps' slices) or whole tiles apart, c - 1/16 first in image 0 and
    c + 1/16 first in image 1: the bin's nearest depth is the lower
    index's. Image 2: depths on the 1/4 grid, so that every pixel lies on a
    centre or halfway between two (count 1/2 to each), and 10 % invalid."""
    p = 256
    tile = chamfer.library().mde_chamfer_tile_pixels(p)
    gen = torch.Generator().manual_seed(13)
    order = torch.randperm(p, generator=gen)
    centers = (1 + 0.5 * order.float())[None].repeat(3, 1)
    where = torch.argsort(order)  # where[k]: the bin of centre 1 + k/2
    assert ((where[1:] - where[:-1]) % 32 == 0).any()
    assert ((where[1:] - where[:-1]) % 32 != 0).any()
    m = 3 * tile + 517
    depth = torch.zeros((3, m))
    pairs = []
    for j in range(24):
        b = 10 * j + 3
        lo = 37 * j + 5
        hi = lo + (tile // 2 if j % 2 else (1 + j // 2 % 2) * tile)
        c = centers[0, b].item()
        depth[0, lo], depth[0, hi] = c - 1 / 16, c + 1 / 16
        depth[1, lo], depth[1, hi] = c + 1 / 16, c - 1 / 16
        pairs.append(b)
    grid = 1 + 0.25 * torch.randint(0, 2 * p - 1, (m,), generator=gen).float()
    depth[2] = torch.where(torch.rand(m, generator=gen) < 0.1, 0.0, grid)
    got = _assert_reductions_match_plain(centers.to(cuda), depth.to(cuda), exact=True)
    min_pb, near = got[0], got[1]
    for b in pairs:
        c = centers[0, b].item()
        assert min_pb[0, b] == min_pb[1, b] == 1 / 256
        assert near[0, b] == c - 1 / 16 and near[1, b] == c + 1 / 16
    assert ((2 * got[2][2]) % 2 == 1).any()  # half counts from split pixels


@pytest.mark.cuda
def test_chamfer_kernel_tie_weights_exact(cuda):
    """One valid pixel an image, at the same distance from t bins, so that
    each of them gets exactly 1/t of its count and depth: t = 1 to 256 bins
    0 .. t-1 (ties across lanes, and inside lanes above 32), and t = 2 to 8
    bins 0, 32, 64, ... (ties inside one lane's bins). Every output equals
    the plain version's bit for bit."""
    p, m = 256, 40
    sets = [list(range(t)) for t in range(1, p + 1)] + [list(range(0, 32 * t, 32))
                                                        for t in range(2, 9)]
    centers = torch.full((len(sets), p), 100.0) + torch.arange(p).float()
    depth = torch.zeros((len(sets), m))
    for i, bins in enumerate(sets):
        centers[i, bins] = 1.0
        depth[i, 17] = 1.5
    got = _assert_reductions_match_plain(centers.to(cuda), depth.to(cuda), exact=True)
    for i, bins in enumerate(sets):
        assert torch.all(got[2][i, bins] == 1 / torch.tensor(float(len(bins))))
    # one term a bin, so the depth sum is exact too
    torch.testing.assert_close(got[3], chamfer.chamfer_reductions_reference(centers, depth)[3],
                               rtol=0, atol=0)


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


# --- the cue path ------------------------------------------------------------

def _cue_args(**kw):
    import types
    base = dict(n_bins=256, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b1", use_semantics="glove-25d",
                use_instance_segmentation="ade20k_swin_human_sizes", insertion_point="input",
                image="rgb", use_fused_head=True, min_depth_eval=1e-3, max_depth_eval=10.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.cuda
@pytest.mark.parametrize("semantics,instances", [
    ("glove-25d", "ade20k_swin_human_sizes"), ("glove-25d-inst-areas", "coco"),
    ("glove-25d-ade20k-places-human-sizes", "ade20k_swin_bbox"), ("raw", "ade20k_swin")])
def test_cue_embedders_on_card_match_cpu(cuda, semantics, instances):
    """Labels with -1 and values past every table: the card's gathers and
    area maps equal the CPU's, NaN in the same places, and no device-side
    assert (the synchronize would raise it)."""
    from mde_tpu_torch.cues import InstanceEmbedder, SemanticsEmbedder
    args = _cue_args(use_semantics=semantics, use_instance_segmentation=instances)
    gen = torch.Generator().manual_seed(8)
    labels = torch.randint(-200, 200, (2, 1, 33, 47), generator=gen, dtype=torch.int32)
    labels.view(-1)[:4] = torch.tensor([-1, 150, -151, 1000], dtype=torch.int32)
    areas = torch.randint(0, 5000, labels.shape, generator=gen).float()
    outs = []
    for device in (cuda, torch.device("cpu")):
        sem, inst = SemanticsEmbedder(args, device), InstanceEmbedder(args, device)
        outs.append([t.cpu() for t in (*sem(labels.to(device)),
                                       *inst(labels.to(device), areas.to(device)))])
        torch.cuda.synchronize()
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_eval_step_launches_the_f32_head_once(cuda):
    """One frame of configuration A through make_eval_step: one float32 head
    forward launch, no other kernel, finite metrics."""
    from mde_tpu_torch.cues import InstanceEmbedder, SemanticsEmbedder
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import make_eval_step
    args = _cue_args()
    torch.manual_seed(0)
    model = build_model(args).to(cuda)
    step = make_eval_step(args, SemanticsEmbedder(args, cuda), InstanceEmbedder(args, cuda))
    gen = torch.Generator().manual_seed(9)
    batch = {"image": torch.randn((1, 3, 320, 416), generator=gen),
             "depth": 0.05 + 9.9 * torch.rand((1, 1, 480, 640), generator=gen),
             "semantics": torch.randint(0, 150, (1, 1, 320, 416), generator=gen),
             "instance_labels": torch.randint(0, 101, (1, 1, 320, 416), generator=gen),
             "instance_areas": torch.randint(0, 9000, (1, 1, 320, 416), generator=gen)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    crop = torch.ones((480, 640), dtype=torch.bool, device=cuda)
    counts = (bins_head.LAUNCHES, bins_head.BWD_LAUNCHES, bins_head.TC_LAUNCHES,
              bins_head.TC_BWD_LAUNCHES, chamfer.LAUNCHES)
    si, metrics, pred = step(model, batch, crop)
    torch.cuda.synchronize()
    after = (bins_head.LAUNCHES, bins_head.BWD_LAUNCHES, bins_head.TC_LAUNCHES,
             bins_head.TC_BWD_LAUNCHES, chamfer.LAUNCHES)
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 0, 0, 0, 0)
    assert torch.isfinite(si).all() and all(torch.isfinite(v).all() for v in metrics.values())
    assert pred.shape == (1, 1, 160, 208) and torch.isfinite(pred).all()


def _nyu_tree(root, n_train, n_eval, eval_hw=(480, 640)):
    """An NYU-format tree with no PIL (the card's machine has none): every
    RGB a copy of the repo's NYU frame, random 16-bit depths (400-9,000 mm)
    by the port's PNG writer; train frames are 480x640, eval frames the
    repo's frame cropped to eval_hw."""
    import os
    import shutil

    import numpy as np

    from mde_tpu_torch.data.decode import read_rgb, write_png
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frame = os.path.join(repo, "test_imgs", "classroom__rgb_00283.jpg")
    scene = root / "classroom_0001"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n_train + n_eval):
        hw = (480, 640) if i < n_train else eval_hw
        if i < n_train:
            shutil.copyfile(frame, scene / f"rgb_{i}.jpg")
        else:  # a PNG crop of the frame: the RGB-PNG path
            write_png(scene / f"rgb_{i}.png", read_rgb(frame)[:hw[0], :hw[1]])
        write_png(scene / f"sync_depth_{i}.png", rng.integers(400, 9000, hw).astype(np.uint16))
        ext = "jpg" if i < n_train else "png"
        lines.append(f"/classroom_0001/rgb_{i}.{ext} /classroom_0001/sync_depth_{i}.png 518.8579")
    (root / "train.txt").write_text("\n".join(lines[:n_train]) + "\n")
    (root / "eval.txt").write_text("\n".join(lines[n_train:]) + "\n")
    return root


def _train_argv(root, *extra):
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [os.path.join(repo, "params", "args_train_nyu_efficientnet-b1.txt"), "--bs", "2",
            "--epochs", "1", "--input_height", "320", "--input_width", "416", "--workers", "4",
            "--root", str(root / "runs"), "--data_path", str(root), "--gt_path", str(root),
            "--filenames_file", str(root / "train.txt"), "--data_path_eval", str(root),
            "--gt_path_eval", str(root), "--filenames_file_eval", str(root / "eval.txt"),
            *extra]


@pytest.mark.cuda
def test_prefetcher_batches_equal_the_loaders(cuda, tmp_path):
    """DevicePrefetcher's batches on the card, NCHW, equal the loader's NHWC
    batches of the same epoch bit for bit, train (native engine) and eval."""
    import numpy as np

    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.data import DepthDataLoader, DevicePrefetcher
    root = _nyu_tree(tmp_path, 4, 2, eval_hw=(320, 416))
    args = parse_cli(TrainArgParser(), _train_argv(root))
    for mode in ("train", "online_eval"):
        loader = DepthDataLoader(args, mode)
        loader.set_epoch(1)
        want = list(loader)
        got = list(DevicePrefetcher(loader, cuda))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key, value in w.items():
                if isinstance(value, np.ndarray) and value.ndim == 4:
                    assert g[key].device.type == "cuda" and g[key].is_contiguous()
                    assert torch.equal(g[key].cpu(), torch.from_numpy(value.transpose(0, 3, 1, 2)))
                elif isinstance(value, np.ndarray):
                    assert np.array_equal(g[key], value), key
                else:
                    assert g[key] == value, key


@pytest.mark.cuda
def test_driver_launches_the_kernels(cuda, tmp_path):
    """main_train on files, bf16, batch 2 of 320x416, 2 steps and one
    validation of 2 frames: 1/2/1 bf16 head forward / backward and chamfer
    launches a step, one bf16 head forward an eval frame (validation runs
    in the training's compute dtype) and one a figure (Train/QualSamples at
    step 0, Test/QualSamples at each validation), no float32 one; a resume
    takes the last step of the epoch from update 2, validates and draws its
    figure."""
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.train import main_train
    root = _nyu_tree(tmp_path, 6, 2, eval_hw=(320, 416))

    def counts():
        return (bins_head.LAUNCHES, bins_head.BWD_LAUNCHES, bins_head.TC_LAUNCHES,
                bins_head.TC_BWD_LAUNCHES, chamfer.LAUNCHES)

    before = counts()
    args = parse_cli(TrainArgParser(), _train_argv(root, "--validate_every", "2"))
    state = main_train(args, max_steps=2, interactive=False)
    torch.cuda.synchronize()
    assert state.step == 2
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 2 + 2 + 2, 4, 2)
    assert len(list((root / "runs" / args.name).glob("*_QualSamples_*.png"))) == 2

    before = counts()
    args = parse_cli(TrainArgParser(), _train_argv(root, "--validate_every", "3",
                                                   "--resume", "latest"))
    args.exp_dir = str(root / "runs" / args.name)
    state = main_train(args, interactive=False)
    torch.cuda.synchronize()
    assert state.step == 3
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 1 + 2 + 1, 2, 1)


@pytest.mark.cuda
def test_evaluate_cli_launches_the_f32_head_once_a_frame(cuda, tmp_path):
    """python -m mde_tpu_torch.evaluate's `main` on params/args_test_nyu.txt
    with a seeded B1 checkpoint, 2 eval frames of 320x416 and --save_dir:
    one float32 head forward a frame (the metrics and the saved PNG come
    from the same forward), no other kernel, finite metrics, one 16-bit PNG
    a frame under the JAX package's names."""
    import os

    from mde_tpu_torch.data.decode import read_png
    from mde_tpu_torch.evaluate import main
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.config import EvalArgParser, parse_cli
    root = _nyu_tree(tmp_path, 0, 2, eval_hw=(320, 416))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [os.path.join(repo, "params", "args_test_nyu.txt"), "--encoder_name",
            "efficientnet-b1", "--data_path_eval", str(root), "--gt_path_eval", str(root),
            "--filenames_file_eval", str(root / "eval.txt"), "--checkpoint_path",
            str(tmp_path / "model.pt"), "--save_dir", str(tmp_path / "pred")]
    torch.manual_seed(0)
    torch.save({"model": build_model(parse_cli(EvalArgParser(), argv, mode="eval"))
                .state_dict()}, tmp_path / "model.pt")
    counts = (bins_head.LAUNCHES, bins_head.BWD_LAUNCHES, bins_head.TC_LAUNCHES,
              bins_head.TC_BWD_LAUNCHES, chamfer.LAUNCHES)
    metrics = main(argv)
    torch.cuda.synchronize()
    after = (bins_head.LAUNCHES, bins_head.BWD_LAUNCHES, bins_head.TC_LAUNCHES,
             bins_head.TC_BWD_LAUNCHES, chamfer.LAUNCHES)
    assert tuple(a - b for a, b in zip(after, counts)) == (2, 0, 0, 0, 0)
    assert all(v == v and abs(v) < float("inf") for v in metrics.values())
    names = sorted(os.listdir(tmp_path / "pred"))
    assert names == ["__classroom_0001__rgb_0.png.png", "__classroom_0001__rgb_1.png.png"]
    assert read_png(tmp_path / "pred" / names[0]).shape == (320, 416)


@pytest.mark.cuda
def test_remat_lowers_the_peak_and_keeps_the_step(cuda):
    """The flagship step at batch 4 of 416x544 under bf16 autocast, with and
    without --remat encoder from the same weights: the same loss to 1e-3
    relative, the BN buffers moved once, and a lower peak of device memory."""
    import types
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state, make_train_step
    base = dict(n_bins=256, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b1", use_semantics=None,
                use_instance_segmentation=None, insertion_point="before-attn", image="rgb",
                w_chamfer=0.1, chamfer=True, epochs=25, lr=0.000357, wd=0.1, div_factor=25.0,
                final_div_factor=100.0, same_lr=False, encoder_lr_factor=1.0, seed=0,
                use_fused_head=True, use_pallas_chamfer=True, compute_dtype="bfloat16",
                accum_steps=1)
    torch.manual_seed(0)
    weights = build_model(types.SimpleNamespace(**base)).state_dict()
    gen = torch.Generator().manual_seed(3)
    batch = {"image": torch.randn((4, 3, 416, 544), generator=gen).to(cuda),
             "depth": (0.05 + 9.9 * torch.rand((4, 1, 416, 544), generator=gen)).to(cuda)}
    out = {}
    for remat in ("none", "encoder"):
        args = types.SimpleNamespace(**base, remat=remat)
        model = build_model(args)
        model.load_state_dict(weights)
        state = create_train_state(model.to(cuda), args, steps_per_epoch=10)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        state, metrics = make_train_step(args)(state, batch)
        torch.cuda.synchronize()
        out[remat] = (metrics["loss"].item(), torch.cuda.max_memory_allocated() - start,
                      {k: v.clone() for k, v in model.named_buffers()})
        del state, model
    (loss, peak, bufs), (r_loss, r_peak, r_bufs) = out["none"], out["encoder"]
    assert abs(r_loss - loss) <= 1e-3 * abs(loss)
    assert r_peak < peak
    for k, v in bufs.items():
        if "num_batches" in k:
            assert int(r_bufs[k]) == int(v) == 1, k
        else:
            torch.testing.assert_close(r_bufs[k], v, rtol=1e-3, atol=1e-5, msg=k)


@pytest.mark.cuda
def test_offline_clis_write_the_side_files_on_the_card(cuda, tmp_path):
    """Both offline CLIs at full width (seeded weights, bf16) on a tree of two
    480x640 frames: one uint8 semantic map and one ade20k label and area
    npz pair a frame, readable by the dataset; the score threshold low
    enough that the seeded head has valid detections."""
    import numpy as np

    from mde_tpu_torch.offline import generate_instances, generate_semantics
    root = _nyu_tree(tmp_path, 2, 0)
    generate_semantics.main(["--images", str(root), "--random-init", "0"])
    generate_instances.main(["--images", str(root), "--random-init", "0", "--score-thr", "0.011"])
    scene = root / "classroom_0001"
    for i in range(2):
        seg = np.load(scene / f"semantic_seg_{i}.npy")
        assert seg.dtype == np.uint8 and seg.shape == (480, 640) and seg.max() < 150
        labels = np.load(scene / f"instance_labels_ade20k_swin_{i}.npz", allow_pickle=True)["arr_0"]
        areas = np.load(scene / f"instance_areas_ade20k_swin_{i}.npz", allow_pickle=True)["arr_0"]
        assert labels.shape == areas.shape == (480, 640) and labels.dtype == np.int32
        assert (labels >= 0).any() and ((labels >= 0) == (areas > 0)).all()


@pytest.mark.cuda
def test_offline_nms_and_roi_align_equal_the_cpu(cuda):
    """nms_fixed over 4,663 boxes (the RPN's candidate count at 800x1088) and
    roi_align / extract_roi_features of 1,000 rois on four FPN levels, the
    same inputs on the card and the CPU: equal (elementwise float32 and a
    fixed order of adds on both)."""
    import numpy as np

    from mde_tpu_torch.offline import detection_ops as ops
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, [1088, 800], (4663, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(4, 300, (4663, 2))], 1)
                             .astype(np.float32))
    scores = torch.from_numpy(rng.uniform(size=4663).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 5, 4663))
    want = ops.batched_nms_fixed(boxes, scores, ids, 0.7, 1000)
    got = ops.batched_nms_fixed(boxes.to(cuda), scores.to(cuda), ids.to(cuda), 0.7, 1000)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    feats = [torch.randn((1, 256, 800 // s, 1088 // s), generator=torch.Generator().manual_seed(s))
             for s in (4, 8, 16, 32)]
    rois = boxes[:1000]
    for size in (7, 14):
        want = ops.extract_roi_features(feats, rois, size)
        got = ops.extract_roi_features([f.to(cuda) for f in feats], rois.to(cuda), size)
        assert torch.equal(got.cpu(), want)
    want = ops.roi_align(feats[0], rois, 7, 0.25)
    assert torch.equal(ops.roi_align(feats[0].to(cuda), rois.to(cuda), 7, 0.25).cpu(), want)


def _coco_tree(root, n_images):
    """n_images copies of the repo's NYU frame with a COCO json over 100
    classes: a polygon, an uncompressed RLE rectangle and a bbox-only box a
    frame (chip_smoke.py phase 11 writes the fuller tree)."""
    import json
    import os
    import shutil

    import numpy as np
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frame = os.path.join(repo, "test_imgs", "classroom__rgb_00283.jpg")
    mask = np.zeros((480, 640), np.uint8)
    mask[100:300, 200:420] = 1
    flat = mask.T.reshape(-1)
    cuts = np.flatnonzero(np.diff(flat)) + 1
    counts = [int(c) for c in np.diff(np.concatenate([[0], cuts, [flat.size]]))]
    images, anns = [], []
    for i in range(n_images):
        shutil.copyfile(frame, root / f"{i}.jpg")
        images.append({"id": i, "file_name": f"{i}.jpg", "height": 480, "width": 640})
        anns += [{"id": 3 * i, "image_id": i, "category_id": 5, "bbox": [50.5, 60.2, 150, 120],
                  "segmentation": [[50.5, 60.2, 200.5, 80.1, 120.7, 180.2]], "iscrowd": 0},
                 {"id": 3 * i + 1, "image_id": i, "category_id": 42, "bbox": [200, 100, 220, 200],
                  "segmentation": {"size": [480, 640], "counts": counts}, "iscrowd": 0},
                 {"id": 3 * i + 2, "image_id": i, "category_id": 99, "bbox": [400, 300, 90, 80],
                  "iscrowd": 0}]
    path = root / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": c, "name": str(c)} for c in range(1, 101)]}))
    return path


@pytest.mark.cuda
def test_train_detector_cli_on_the_card(cuda, tmp_path):
    """train_detector at full width on the card (bf16, use_checkpoint, 100
    classes, the full AutoAugment scale set): 3 steps, finite losses, no
    port kernel launched, and the checkpoint loads strictly through
    load_detector with every tensor equal."""
    import math

    from mde_tpu_torch.offline import train_detector
    from mde_tpu_torch.offline.cascade_rcnn import load_detector
    ann = _coco_tree(tmp_path, 2)
    seen = []
    real = train_detector.train_step

    def step(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    train_detector.train_step = step
    before = (bins_head.LAUNCHES, bins_head.TC_LAUNCHES, chamfer.LAUNCHES)
    try:
        model = train_detector.main(["--images", str(tmp_path), "--annotations", str(ann),
                                     "--max-steps", "3", "--out", str(tmp_path / "run")])
    finally:
        train_detector.train_step = real
    assert (bins_head.LAUNCHES, bins_head.TC_LAUNCHES, chamfer.LAUNCHES) == before
    assert len(seen) == 3 and all(math.isfinite(float(v)) for s in seen for v in s.values())
    loaded = load_detector(str(tmp_path / "run" / "detector_latest.pth")).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[k], v.cpu()), k


@pytest.mark.cuda
def test_hrnet_train_step_equals_the_cpu(cuda):
    """One HRNetV2-W48 + C1 step (150 classes, float32, TF32 off, SGD +
    poly) at 128x192, batch 2, on the card and on the CPU: loss rtol 1e-4,
    every BatchNorm buffer within 1e-4 of its largest value."""
    from mde_tpu_torch.offline.hrnet import HRNetV2C1
    from mde_tpu_torch.offline.hrnet_train import build_semseg_optimizer, make_semseg_train_step
    from mde_tpu_torch.offline.layers import seeded
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 128, 192), generator=g)
    labels = torch.randint(0, 150, (2, 32, 48), generator=g)
    labels[:, 0] = -1
    out = {}
    for device in ("cpu", cuda):
        model = seeded(HRNetV2C1, 0).to(device)
        opt, sched = build_semseg_optimizer(model)
        loss = make_semseg_train_step(model, opt, sched)(x.to(device), labels.to(device))["loss"]
        out[str(device)] = (float(loss), {n: b.cpu() for n, b in model.named_buffers()})
    (l_cpu, b_cpu), (l_gpu, b_gpu) = out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for n, want in b_cpu.items():
        err = (b_gpu[n] - want).abs().max() / want.abs().max().clamp(min=1e-30)
        assert err <= 1e-4, (n, float(err))


@pytest.mark.cuda
@pytest.mark.parametrize("arch_encoder,arch_decoder", [
    ("resnet18dilated", "c1_deepsup"), ("resnet50dilated", "ppm_deepsup"),
    ("mobilenetv2dilated", "c1_deepsup"), ("resnext101", "upernet")])
def test_semseg_zoo_forward_equals_the_cpu(cuda, arch_encoder, arch_decoder):
    """A zoo model at its published widths, 150 classes, seeded weights,
    float32 (TF32 off), batch 1 of 128x160: the log-probabilities on the
    card within 1e-4 of the largest CPU value (seeded logits reach the
    thousands, so a near-tie's softmax is no measure of the error)."""
    from mde_tpu_torch.offline.layers import seeded
    from mde_tpu_torch.offline.semseg_zoo import SegmentationModel
    model = seeded(lambda: SegmentationModel(arch_encoder, arch_decoder), 0)
    x = torch.randn((1, 3, 128, 160), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert torch.isfinite(got).all() and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
