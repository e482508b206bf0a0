"""Port parity, training losses and the chamfer kernel's plain version:
mde_tpu_torch.ops.losses and mde_tpu_torch.kernels.chamfer against
mde_tpu.ops.losses and the Pallas kernel mde_tpu.kernels.chamfer run in
interpret mode, as tests/test_kernels.py runs it (CPU, float32).

Tolerances: SILog value and gradient rtol 1e-5 (float32 sums in other
orders); the chamfer value rtol 1e-5 and its gradient to the bin edges
rtol 1e-4 / atol 1e-6, those of tests/test_kernels.py:23-59; the per-bin and
per-pixel reductions rtol 1e-5 / atol 1e-6.

The nearest depth of a bin is compared on tie-free data only: the Pallas
kernel keeps the first strict winner of each lane and then picks a lane, the
port keeps the lowest pixel index (ROADMAP §3 "Chamfer tie semantics"). The
tie case checks the value and the per-pixel side only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.kernels import chamfer as jax_chamfer
from mde_tpu.ops import losses as jax_losses
from mde_tpu.ops.bins import bin_edges_from_widths
from mde_tpu_torch.kernels import chamfer
from mde_tpu_torch.ops import losses

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("interpolate,masked", [(True, True), (False, True), (True, False)])
def test_silog_value_and_gradient_match_jax(interpolate, masked):
    rng = np.random.default_rng(0)
    hw = (12, 20) if interpolate else (24, 40)
    pred = (0.1 + 9 * rng.random((2, *hw, 1))).astype(np.float32)
    target = (9.9 * rng.random((2, 24, 40, 1)) + 0.05).astype(np.float32)
    target[:, :3] = 0.0
    mask = target > 1e-3 if masked else None

    def jax_loss(p):
        return jax_losses.silog_loss(p, jnp.asarray(target),
                                     None if mask is None else jnp.asarray(mask), interpolate)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    p = _nchw(pred).requires_grad_()
    got = losses.silog_loss(p, _nchw(target), None if mask is None else _nchw(mask), interpolate)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy().transpose(0, 2, 3, 1), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-9)


def _setup(seed=0, n=2, p=16, hw=(24, 32)):
    """Bin edges and depths as tests/test_kernels.py makes them: depths under
    0.4 m are zero (not valid)."""
    rng = np.random.default_rng(seed)
    widths = rng.random((n, p), dtype=np.float32)
    widths /= widths.sum(1, keepdims=True)
    edges = np.asarray(bin_edges_from_widths(jnp.asarray(widths), 1e-3, 10.0))
    depth = rng.random((n, *hw, 1), dtype=np.float32) * 10
    depth[depth < 0.4] = 0.0
    return edges, depth


def _port_value_and_grad(fn, edges, depth):
    e = _t(edges).requires_grad_()
    value = fn(e, _nchw(depth))
    value.backward()
    return value.item(), e.grad.numpy()


CASES = {"dense": dict(seed=0), "ragged": dict(seed=3, hw=(7, 9), p=32),
         "wide": dict(seed=5, n=3, hw=(33, 49), p=256)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("pair", ["plain_loss", "kernel_entry"])
def test_chamfer_value_and_gradient_match_jax(case, pair):
    """The chunked plain loss against the JAX one, and the port's kernel
    entry (its plain reductions on the CPU) against the Pallas kernel in
    interpret mode. The ragged case has 63 pixels, not a multiple of the
    128-pixel lane tile. Each pair shares its tie rule: the "wide" case (3 x
    1617 pixels, 256 bins) has a bin with two valid depths at the same
    distance, where autodiff through min splits the gradient and the
    kernels give it to one depth."""
    edges, depth = _setup(**CASES[case])
    if pair == "plain_loss":
        fn = lambda e: jax_losses.bins_chamfer_loss(e, jnp.asarray(depth), chunk=96)
        port = lambda e, d: losses.bins_chamfer_loss(e, d, chunk=96)
    else:
        fn = lambda e: jax_chamfer.chamfer_1d_pallas(e, jnp.asarray(depth), tile=128,
                                                     interpret=True)
        port = chamfer.chamfer_1d
    want, want_grad = jax.value_and_grad(fn)(jnp.asarray(edges))
    got, got_grad = _port_value_and_grad(port, edges, depth)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("port_fn", [losses.bins_chamfer_loss, chamfer.chamfer_1d])
def test_chamfer_all_invalid_image_gives_zero(port_fn):
    """An image with no valid depth adds nothing and gets no gradient, as
    in the Pallas kernel and the JAX loss."""
    edges, depth = _setup(seed=1)
    depth[1] = 0.0
    fn = lambda e: jax_chamfer.chamfer_1d_pallas(e, jnp.asarray(depth), tile=128,
                                                 interpret=True)
    want, want_grad = jax.value_and_grad(fn)(jnp.asarray(edges))
    got, got_grad = _port_value_and_grad(port_fn, edges, depth)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), rtol=1e-4, atol=1e-6)
    assert np.all(got_grad[1] == 0)
    zero, zero_grad = _port_value_and_grad(port_fn, edges, np.zeros_like(depth))
    assert zero == 0.0 and np.all(zero_grad == 0)


def _pallas_reductions(centers, depth_flat, tile=128):
    """Per image through the Pallas kernel, in interpret mode."""
    m = depth_flat.shape[1]
    pad = (-m) % tile
    outs = []
    for c, d in zip(centers, depth_flat):
        d = np.pad(d, (0, pad))
        valid = ((d >= 1e-3) & (np.arange(d.size) < m)).astype(np.float32)
        outs.append([np.asarray(o) for o in jax_chamfer._chamfer_reductions(
            jnp.asarray(d), jnp.asarray(valid), jnp.asarray(c), tile, interpret=True)])
    return [np.stack(o) for o in zip(*outs)]


def _port_reductions(centers, depth_flat):
    return [t.numpy() for t in chamfer.chamfer_reductions(_t(centers), _t(depth_flat))]


@pytest.mark.parametrize("case", ["dense", "ragged"])
def test_chamfer_reductions_match_pallas_tie_free(case):
    """All outputs, the nearest-depth payload included, on random depths,
    where no two valid depths are at the same distance from a centre."""
    edges, depth = _setup(**CASES[case])
    centers = (0.5 * (edges[:, 1:] + edges[:, :-1])).astype(np.float32)
    flat = depth.reshape(depth.shape[0], -1)
    min_pb, near, cnt_pb, sumd_pb, sum_y, cnt = _pallas_reductions(centers, flat)
    got = _port_reductions(centers, flat)
    np.testing.assert_allclose(got[0], min_pb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], near, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], cnt_pb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3], sumd_pb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[4].sum(1), sum_y, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal((flat >= 1e-3).sum(1), cnt)


def test_chamfer_tie_case_value_and_pixel_side_match_pallas():
    """Centres 1, 2, 3, 4 m. Depth 1.5 is as near to the first two centres
    (its count splits 0.5 / 0.5), and 1.75 and 2.25 are as near to centre
    2 (a tie on the per-bin side, whose nearest depth the two kernels pick
    by different rules)."""
    edges = np.array([[0.5, 1.5, 2.5, 3.5, 4.5]], np.float32)
    depth = np.array([1.5, 1.75, 2.25, 3.9, 0.0, 1.5, 3.1], np.float32)
    depth = np.tile(depth, 19)[None, :128, None, None]
    centers = np.array([[1.0, 2.0, 3.0, 4.0]], np.float32)
    flat = depth.reshape(1, -1)
    min_pb, _, cnt_pb, sumd_pb, sum_y, _ = _pallas_reductions(centers, flat)
    got = _port_reductions(centers, flat)
    np.testing.assert_allclose(got[0], min_pb, rtol=1e-6)
    np.testing.assert_allclose(got[2], cnt_pb, rtol=1e-6)
    np.testing.assert_allclose(got[3], sumd_pb, rtol=1e-6)
    np.testing.assert_allclose(got[4].sum(1), sum_y, rtol=1e-6)
    assert got[2][0, 0] % 1 == 0.5  # the split count
    want = jax_chamfer.chamfer_1d_pallas(jnp.asarray(edges), jnp.asarray(depth), tile=128,
                                         interpret=True)
    for port_fn in (losses.bins_chamfer_loss, chamfer.chamfer_1d):
        np.testing.assert_allclose(port_fn(_t(edges), _nchw(depth)).item(), float(want),
                                   rtol=1e-6)
