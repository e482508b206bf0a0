"""Port parity, bins-head kernel: the plain version of
mde_tpu_torch.kernels.bins_head against the Pallas kernel
mde_tpu.kernels.bins_head.fused_bins_head run in interpret mode, as
tests/test_kernels.py runs it. Forward tolerances are those of
tests/test_kernels.py: rtol/atol 1e-5 in float32, 2e-2 in bfloat16 (the
rounding points are the same, the summation orders are not). The gradients
(autograd through the plain version against `jax.vjp` through the Pallas
backward kernel) are held at rtol 1e-4 in float32, as
tests/test_kernels.py:111-127 holds them, and 2e-2 in bfloat16, each with an
atol of that fraction of the tensor's largest value (entries near zero).

On the CPU the wrapper runs the plain version and launches nothing; the CUDA
kernel itself is compared with the plain version on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.kernels import bins_head as jax_bins_head
from mde_tpu.ops.bins import bin_edges_from_widths
from mde_tpu_torch.kernels import bins_head

torch.set_num_threads(2)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _head_inputs(seed=0, b=2, h=8, w=16, n=128):
    """Seeded numpy inputs: features NHWC, kernel (1,1,128,n), bias, centers."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, h, w, 128)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((1, 1, 128, n))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n,))).astype(np.float32)
    widths = rng.random((b, n), dtype=np.float32)
    widths /= widths.sum(1, keepdims=True)
    edges = np.asarray(bin_edges_from_widths(jnp.asarray(widths), 1e-3, 10.0))
    centers = (0.5 * (edges[:, 1:] + edges[:, :-1])).astype(np.float32)
    return feats, kernel, bias, centers


def _port_args(feats, kernel, bias, centers, dtype):
    """The same inputs in the port's layout: NCHW features, OIHW weight."""
    x = torch.from_numpy(feats.transpose(0, 3, 1, 2).copy()).to(dtype)
    weight = torch.from_numpy(kernel[0, 0].T.copy())[:, :, None, None]
    return x, weight, torch.from_numpy(bias), torch.from_numpy(centers)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [128, 256])
def test_plain_head_matches_pallas_kernel(dtype, n):
    feats, kernel, bias, centers = _head_inputs(seed=n, n=n)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_bins_head.fused_bins_head(jnp.asarray(feats, jdtype), jnp.asarray(kernel),
                                         jnp.asarray(bias), jnp.asarray(centers),
                                         interpret=True)
    bins_head.LAUNCHES = 0
    got = bins_head.fused_bins_head(*_port_args(feats, kernel, bias, centers, dtype))
    assert bins_head.LAUNCHES == 0
    assert got.shape == (2, 1, 8, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [128, 256])
def test_plain_head_gradients_match_pallas_backward(dtype, n):
    """dfeatures, dkernel, dbias and dcenters for a random depth gradient."""
    feats, kernel, bias, centers = _head_inputs(seed=n + 1, n=n)
    upstream = np.random.default_rng(n).standard_normal((2, 8, 16, 1)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    fn = lambda f, k, b, c: jax_bins_head.fused_bins_head(f, k, b, c, interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(feats, jdtype), jnp.asarray(kernel), jnp.asarray(bias),
                     jnp.asarray(centers))
    want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(upstream))]

    inputs = [t.requires_grad_() for t in _port_args(feats, kernel, bias, centers, dtype)]
    out = bins_head.fused_bins_head(*inputs)
    out.backward(torch.from_numpy(upstream.transpose(0, 3, 1, 2).copy()))
    assert inputs[0].grad.dtype == dtype
    got = [inputs[0].grad.float().numpy().transpose(0, 2, 3, 1),
           inputs[1].grad.numpy()[:, :, 0, 0].T[None, None],
           inputs[2].grad.numpy(), inputs[3].grad.numpy()]
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    for name, g, r in zip(("dfeatures", "dkernel", "dbias", "dcenters"), got, want):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("h,w,n", [(8, 16, 128), (240, 320, 256), (160, 208, 256),
                                   (7, 9, 128), (8, 16, 100), (33, 49, 256)])
def test_supported_predicate_matches_jax(h, w, n):
    assert bins_head.fused_head_supported(h, w, n) == jax_bins_head.fused_head_supported(h, w, n)


def _bad_inputs():
    x, w, b, c = _port_args(*_head_inputs(), torch.float32)
    return {
        "channels": ((x[:, :64], w[:, :64], b, c), ValueError),
        "bins": ((x, w[:100], b[:100], c[:, :100]), ValueError),
        "bias_shape": ((x, w, b[:64], c), ValueError),
        "centers_batch": ((x, w, b, c[:1]), ValueError),
        "feature_dtype": ((x.half(), w, b, c), TypeError),
        "weight_dtype": ((x, w.double(), b, c), TypeError),
        "bias_dtype": ((x, w, b.half(), c), TypeError),
        "device": ((x.to("meta"), w.to("meta"), b.to("meta"), c.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, err = _bad_inputs()[case]
    with pytest.raises(err):
        bins_head.fused_bins_head(*args)
