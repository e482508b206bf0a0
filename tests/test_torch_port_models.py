"""Port parity, model pieces: mde_tpu_torch.models against mde_tpu.models on
the same weights and inputs (CPU, float32).

The JAX weights are made once per module: the parameter tree's shapes come
from `jax.eval_shape(model.init)` (tracing only; a compiled init of the full
model takes ~20 s on this CPU) and are filled from a numpy seed at lecun
scale, with BN running stats reset to mean +-0.1, var 0.5-1.5. They reach the
port through `state_dict_from_flax` and `load_state_dict(strict=True)`.

Tolerance rtol 1e-4, atol 1e-4: oneDNN and XLA sum the convolutions in
different orders, and the differences grow through the encoder's depth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.models.decoder import DecoderBN as JaxDecoderBN
from mde_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from mde_tpu.models.mvit import MViT as JaxMViT
from mde_tpu.models.unet_adaptive_bins import UnetAdaptiveBins as JaxUnetAdaptiveBins
from mde_tpu_torch.checkpoint import state_dict_from_flax
from mde_tpu_torch.models import UnetAdaptiveBins
from mde_tpu_torch.models.mvit import MViT

torch.set_num_threads(2)

RTOL = ATOL = 1e-4


def flax_variables(n_bins=256, seed=0):
    """(params, batch_stats) of a JAX B1 UnetAdaptiveBins as numpy trees."""
    model = JaxUnetAdaptiveBins(n_bins=n_bins, min_val=1e-3, max_val=10.0,
                                encoder_name="efficientnet-b1")
    return seeded_variables(model, [(1, 320, 416, 3)], seed)


def seeded_variables(model, input_shapes, seed):
    """(params, batch_stats) of a JAX model as numpy trees, for float32
    inputs of `input_shapes` (None for an input not given)."""
    inputs = [None if s is None else jax.ShapeDtypeStruct(s, jnp.float32)
              for s in input_shapes]
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "positional_encodings":
            return rng.random(shape, dtype=np.float32)
        if name == "mean":
            return rng.uniform(-0.1, 0.1, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        raise KeyError(name)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return variables["params"], variables["batch_stats"]


def port_model(params, stats, **kw):
    model = UnetAdaptiveBins(n_bins=256, min_val=1e-3, max_val=10.0,
                             encoder_name="efficientnet-b1", **kw)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def weights():
    params, stats = flax_variables()
    return params, stats, port_model(params, stats)


@pytest.fixture(scope="module")
def encoder_features(weights):
    """Encoder features of both frameworks at an odd input size (66x98)."""
    params, stats, model = weights
    x = np.random.default_rng(1).standard_normal((1, 66, 98, 3)).astype(np.float32)
    jax_feats = jax.jit(lambda v, x: JaxEncoder("efficientnet-b1").apply(v, x, train=False))(
        {"params": params["encoder"], "batch_stats": stats["encoder"]}, x)
    with torch.no_grad():
        port_feats = model.encoder(nchw(x))
    return [np.asarray(f) for f in jax_feats], port_feats


@pytest.mark.parametrize("index", range(1, 14))
def test_encoder_feature_matches_jax(encoder_features, index):
    jax_feats, port_feats = encoder_features
    assert len(port_feats) == len(jax_feats) == 14
    np.testing.assert_allclose(nhwc(port_feats[index]), jax_feats[index],
                               rtol=RTOL, atol=ATOL)


def test_decoder_matches_jax(weights, encoder_features):
    params, stats, model = weights
    jax_feats, _ = encoder_features
    want = jax.jit(lambda v, f: JaxDecoderBN(num_features=1280).apply(v, f, train=False))(
        {"params": params["decoder"], "batch_stats": stats["decoder"]}, jax_feats)
    with torch.no_grad():
        got = model.decoder([nchw(f) for f in jax_feats])
    assert got.shape == (1, 128, 33, 49)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["linear", "softmax", "sigmoid"])
def test_mvit_matches_jax(weights, norm):
    """176x192 maps give 11*12 = 132 tokens, enough for the 128 queries."""
    params, _, _ = weights
    x = np.random.default_rng(2).standard_normal((1, 176, 192, 128)).astype(np.float32)
    jax_mvit = JaxMViT(n_query_channels=128, patch_size=16, dim_out=256,
                       embedding_dim=128, norm=norm)
    want_bins, want_maps = jax.jit(lambda v, x: jax_mvit.apply(v, x))(
        {"params": params["adaptive_bins_layer"]}, x)
    mvit = MViT(128, n_query_channels=128, patch_size=16, dim_out=256,
                embedding_dim=128, norm=norm)
    prefix = "adaptive_bins_layer."
    mvit.load_state_dict({k[len(prefix):]: v for k, v in weights[2].state_dict().items()
                          if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got_bins, got_maps = mvit.eval()(nchw(x))
    assert got_maps.shape == (1, 128, 176, 192)
    np.testing.assert_allclose(got_bins.numpy(), np.asarray(want_bins), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(nhwc(got_maps), np.asarray(want_maps), rtol=RTOL, atol=ATOL)


def test_model_needs_129_tokens(weights):
    """Below 129 mViT tokens the reference's conv_out input width shrinks; the
    port, whose conv_out.0 always takes 128 channels, refuses the input."""
    with torch.no_grad(), pytest.raises(ValueError, match="129 tokens"):
        weights[2](torch.zeros(1, 3, 64, 128))
