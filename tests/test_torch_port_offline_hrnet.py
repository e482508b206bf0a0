"""Port parity, the offline semantics generator: mde_tpu_torch.offline.hrnet
against mde_tpu.offline.hrnet (CPU, float32).

The port keeps CSAILVision's state_dict names, so the JAX model is seeded
through its own converter: the port's encoder and decoder state_dicts go to
files, `mde_tpu.offline.hrnet_convert.convert_hrnet_c1` reads them, and the
JAX model runs on the tree it returns (no JAX init). A misnamed or missing
key fails in the converter, and the keys it reads are recorded, so a port
key that it never reads fails too.

Tolerances: HRNetV2-W48 + C1 at full width on a 64x64 input, float32:
softmax scores at seg_size within 2e-5 absolute (they are probabilities),
log-softmax within 1e-4 absolute; two float32 stacks of ~170 convolutions
summed in other orders. The host protocol of the multiscale inference (PIL
resize, normalisation, padding, sum, argmax) is held exactly on the NYU
frame, through one cheap apply_fn that both sides call.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.offline import hrnet as jax_hrnet
from mde_tpu.offline.hrnet_convert import convert_hrnet_c1
from mde_tpu_torch.offline import hrnet
from mde_tpu_torch.offline.layers import BatchNorm2d, seeded

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CLASSROOM = REPO / "test_imgs" / "classroom__rgb_00283.jpg"
HW = (64, 64)
# the input of the parity tests, NHWC; the BatchNorms are calibrated on it
X = np.random.default_rng(0).standard_normal((1, *HW, 3), dtype=np.float32)


class _Recording(dict):
    """A state_dict that records the keys read from it."""

    def __init__(self, *a, read):
        super().__init__(*a)
        self.read = read

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@torch.no_grad()
def calibrate_norms_(model, x, seed):
    """Seeded BatchNorm weights and biases, and running stats set from one
    forward of `x`, each BatchNorm from its own input (per-channel means, the
    layer's mean variance, each times a seeded factor): so every stat is
    non-trivial and the activations stay O(1) through the ~170 layers (with
    flax's initialisation and identity stats the logits reach ~500 and the
    softmax is one-hot)."""
    g = torch.Generator().manual_seed(seed)

    def calibrate(m, inputs):
        t = inputs[0].float()
        m.running_mean.copy_(t.mean((0, 2, 3)) + 0.1 * torch.randn(t.shape[1], generator=g))
        # the layer's mean variance: a channel that is near constant on this
        # small input would otherwise be scaled up, and f32 noise with it
        m.running_var.copy_(t.var((0, 2, 3)).mean() * (torch.rand(t.shape[1], generator=g) + 0.5))

    hooks = []
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.weight.copy_(torch.rand(m.weight.numel(), generator=g) + 0.5)
            m.bias.copy_(0.1 * torch.randn(m.weight.numel(), generator=g))
            hooks.append(m.register_forward_pre_hook(calibrate))
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return model


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(port model, JAX variables, keys the converter read, the port's keys)."""
    model = calibrate_norms_(seeded(hrnet.HRNetV2C1, 0),
                             torch.from_numpy(X).permute(0, 3, 1, 2), 1)
    tmp = tmp_path_factory.mktemp("hrnet")
    enc, dec = tmp / "encoder_epoch_30.pth", tmp / "decoder_epoch_30.pth"
    torch.save(model.encoder.state_dict(), enc)
    torch.save(model.decoder.state_dict(), dec)
    read = {enc: set(), dec: set()}
    real_load = torch.load

    def load(path, *a, **k):
        return _Recording(real_load(path, *a, **k), read=read[Path(path)])

    torch.load = load
    try:
        params, stats = convert_hrnet_c1(str(enc), str(dec))
    finally:
        torch.load = real_load
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    own = {enc: set(model.encoder.state_dict()), dec: set(model.decoder.state_dict())}
    yield model, variables, read, own, (enc, dec)
    enc.unlink()  # ~270 MB
    dec.unlink()


@pytest.fixture(scope="module")
def outputs(converted):
    """Both models' softmax at seg_size and log-softmax, one JAX compile."""
    model, variables, *_ = converted
    jmodel = jax_hrnet.HRNetV2C1(dtype=jnp.float32)

    @jax.jit
    def both(v, x):
        return (jmodel.apply(v, x, seg_size=HW, train=False),
                jmodel.apply(v, x, train=False))

    want_soft, want_log = (np.asarray(a).transpose(0, 3, 1, 2) for a in both(variables, X))
    xt = torch.from_numpy(X).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_soft, got_log = model(xt, seg_size=HW).numpy(), model(xt).numpy()
    return got_soft, want_soft, got_log, want_log


def test_softmax_at_seg_size_matches_jax(outputs):
    got, want, *_ = outputs
    assert got.shape == want.shape == (1, 150, *HW)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # neither flat nor one-hot, so the comparison sees the logits
    assert 0.05 < want.max() < 0.999 and want.min() < 1e-3


def test_log_softmax_matches_jax(outputs):
    *_, got, want = outputs
    assert got.shape == want.shape == (1, 150, HW[0] // 4, HW[1] // 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_converter_reads_every_port_key(converted):
    _, _, read, own, _ = converted
    for path in read:
        assert own[path] - read[path] == set(), f"{path.name}: keys the converter never reads"
        assert read[path] <= own[path]


def test_load_hrnet_c1_loads_the_csail_pair_and_refuses_bad_keys(converted, tmp_path):
    model, _, _, _, (enc, dec) = converted
    loaded = hrnet.load_hrnet_c1(str(enc), str(dec)).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[k], v), k
    sd = torch.load(dec, weights_only=True)
    sd["cbr.1.num_batches_tracked"] = torch.tensor(7)  # CSAIL files carry these
    torch.save(sd, tmp_path / "dec_counts.pth")
    hrnet.load_hrnet_c1(str(enc), str(tmp_path / "dec_counts.pth"))
    bad = dict(sd)
    bad["cbr.2.weight"] = bad.pop("cbr.0.weight")
    torch.save(bad, tmp_path / "dec_bad.pth")
    with pytest.raises(KeyError, match=r"cbr\.0\.weight.*cbr\.2\.weight"):
        hrnet.load_hrnet_c1(str(enc), str(tmp_path / "dec_bad.pth"))
    with pytest.raises(KeyError, match=r"conv1\.weight"):  # the halves swapped
        hrnet.load_hrnet_c1(str(dec), str(enc))
    bf16 = hrnet.load_hrnet_c1(str(enc), str(dec), dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert bf16.encoder.bn1.weight.dtype == torch.float32  # norms stay float32


@pytest.mark.parametrize("hw", [(480, 640), (375, 500), (640, 480), (1200, 333), (17, 23)])
def test_scale_plan_and_rounding_match_jax(hw):
    assert hrnet._scale_plan(*hw) == jax_hrnet._scale_plan(*hw)
    for x in (1, 31, 32, 33, 600, 1000):
        assert hrnet.round2nearest_multiple(x, 32) == jax_hrnet.round2nearest_multiple(x, 32)


def test_multiscale_host_protocol_matches_jax_on_the_nyu_frame():
    """The same cheap apply_fn on both sides: a fixed 1x1
    projection of the padded input, upsampled by nearest neighbour to the
    frame and soft-maxed (20 classes). So the PIL resize, the normalisation, the padding,
    the sum and the argmax are held with no model compile; both sides see
    the same float32 inputs, so the maps are equal."""
    from PIL import Image
    img = np.asarray(Image.open(CLASSROOM), dtype=np.float32) / 255.0
    proj = np.random.default_rng(3).standard_normal((3, 20)).astype(np.float32)
    seen = {"jax": [], "port": []}

    def scores(x_nhwc, hw):
        h, w = hw
        ph, pw = x_nhwc.shape[1:3]
        iy = np.arange(h) * ph // h
        ix = np.arange(w) * pw // w
        logits = x_nhwc[0][iy][:, ix] @ proj
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True))[None]

    def jax_apply(v, x, hw):
        seen["jax"].append(np.asarray(x))
        return jnp.asarray(scores(np.asarray(x), hw))

    def port_apply(x, hw):
        x = x.permute(0, 2, 3, 1).numpy()
        seen["port"].append(x)
        return torch.from_numpy(scores(x, hw)).permute(0, 3, 1, 2)

    want = jax_hrnet.hrnet_multiscale_inference(jax_apply, None, img)
    got = hrnet.hrnet_multiscale_inference(port_apply, img)
    assert len(seen["port"]) == len(seen["jax"]) == 5
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    assert got.dtype == want.dtype == np.int32 and got.shape == (480, 640)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 5
