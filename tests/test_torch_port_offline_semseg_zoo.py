"""Port parity, CSAIL's semantic-segmentation zoo: mde_tpu_torch.offline.
semseg_zoo against mde_tpu.offline.semseg_zoo (CPU).

The port keeps CSAIL's state_dict names. The JAX models are seeded from the
port's seeded state_dicts: the ResNet encoders through the JAX package's own
`convert_resnet_encoder` (hrnet_convert.py:102), MobileNetV2 and the
decoders through the mapping below (JAX has no converter for them). Every
port key is read, the deep-supervision tensors aside (held, never used).
The BatchNorms are calibrated on each test's input (`calibrate_norms_`), so
the logits are O(1).

* Full models, float32, batch 1 of 64x96: resnet18 (basic blocks,
  undilated) + C1 and mobilenetv2dilated + C1 (its deep-supervision
  file's tensors held): log-probabilities within 1e-4 absolute, the softmax
  at seg_size within 1e-5 absolute. resnet50dilated (stride 8) + PPM, whose
  float32 noise on either side is larger (JAX's own float32 model lies
  3.0e-4 from its float64 one in the log-probabilities), through the
  float64 reading: the port's float64 model within 1e-10 of JAX's float64
  model (JAX's float32 casts read as float64), the port's float32 model
  within 1e-3 (log-probabilities) and 2e-5 (softmax) of it.
* UPerNet's decoder on seeded ResNet-50-wide features (256-2048 channels,
  strides 4-32 of 128x192), and resnext101's grouped block (32 groups,
  expansion 2, with its downsample), at the same tolerances (the block's
  output within 1e-5 of its largest value). resnet101 adds only depth to
  resnet50; the card runs it whole.
* One `make_semseg_train_step` of resnet18dilated + PPM (8 classes, batch 2
  of 48x48, labels at 6x6 with ignored pixels, SGD + poly) against JAX's
  float32 and float64 steps under
  test_torch_port_offline_hrnet_train.py's rule: loss and accuracy rtol
  1e-5, each parameter and BatchNorm stat within twice JAX's float32
  distance from its float64 step (plus 1e-5) or its name's noise bound.
* CSAIL-named state_dicts (keys written out here from CSAIL's module
  layout, BatchNorm batch counters and deep-supervision tensors included)
  load through `load_segmentation_model` with no missing or unexpected key.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.offline import hrnet as jax_hrnet
from mde_tpu.offline import hrnet_train as jax_train
from mde_tpu.offline import semseg_zoo as jax_zoo
from mde_tpu.offline.hrnet_convert import _bn, _bottleneck, _conv, convert_resnet_encoder
from mde_tpu.ops import resize as jax_resize
from mde_tpu_torch.offline import hrnet_train, semseg_zoo
from mde_tpu_torch.offline.layers import BatchNorm2d, load_checked, seeded
from test_torch_port_offline_hrnet_train import _hold, _WidestJnp

torch.set_num_threads(2)

HW = (64, 96)
LOG_TOL, SOFT_TOL = 1e-4, 1e-5
# resnet50dilated + PPM's float32 log-probabilities and softmax against the
# float64 reading (measured: the port 4.4e-4 and 9.0e-6, JAX's own float32
# model 3.0e-4 and 5.0e-6; the two float64 models 6.6e-13 and 1.3e-14)
FLOAT32_NOISE = (1e-3, 2e-5)
FLOAT64_AGREE = 1e-10
N_CLASSES = 8
BASE_LR, MAX_ITERS = 0.02, 100


class _Read(dict):
    """A state_dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _mobilenet(sd):
    p, s = {"stem": _conv(sd, "features.0.0")}, {}
    p["stem_bn"], s["stem_bn"] = _bn(sd, "features.0.1")
    k = 1
    for si, (t, _, n, _) in enumerate(semseg_zoo._MOBILENETV2):
        for b in range(n):
            bp, bs = {}, {}
            names = (("dw", 0), ("pwl", 3)) if t == 1 else (("pw", 0), ("dw", 3), ("pwl", 6))
            for name, i in names:
                bp[name] = _conv(sd, f"features.{k}.conv.{i}")
                bp[name + "_bn"], bs[name + "_bn"] = _bn(sd, f"features.{k}.conv.{i + 1}")
            p[f"block{si}_{b}"], s[f"block{si}_{b}"] = bp, bs
            k += 1
    return p, s


def _decoder(arch, sd):
    p, s = {}, {}
    if arch.startswith("c1"):
        p["cbr_conv"] = _conv(sd, "cbr.0")
        p["cbr_bn"], s["cbr_bn"] = _bn(sd, "cbr.1")
        p["conv_last"] = _conv(sd, "conv_last")
        return p, s
    if arch.startswith("ppm"):
        for i in range(4):
            p[f"pool{i}_conv"] = _conv(sd, f"ppm.{i}.1")
            p[f"pool{i}_bn"], s[f"pool{i}_bn"] = _bn(sd, f"ppm.{i}.2")
        p["fusion_conv"] = _conv(sd, "conv_last.0")
        p["fusion_bn"], s["fusion_bn"] = _bn(sd, "conv_last.1")
        p["conv_last"] = _conv(sd, "conv_last.4")
        return p, s
    for i in range(4):
        p[f"ppm{i}_conv"] = _conv(sd, f"ppm_conv.{i}.0")
        p[f"ppm{i}_bn"], s[f"ppm{i}_bn"] = _bn(sd, f"ppm_conv.{i}.1")
        p[f"fpn_out{i}_conv"] = _conv(sd, f"fpn_out.{i}.0.0")
        p[f"fpn_out{i}_bn"], s[f"fpn_out{i}_bn"] = _bn(sd, f"fpn_out.{i}.0.1")
    for i in range(3):
        p[f"lat{i}_conv"] = _conv(sd, f"fpn_in.{i}.0")
        p[f"lat{i}_bn"], s[f"lat{i}_bn"] = _bn(sd, f"fpn_in.{i}.1")
    p["ppm_last_conv"] = _conv(sd, "ppm_last_conv.0")
    p["ppm_last_bn"], s["ppm_last_bn"] = _bn(sd, "ppm_last_conv.1")
    p["fusion_conv"] = _conv(sd, "conv_last.0.0")
    p["fusion_bn"], s["fusion_bn"] = _bn(sd, "conv_last.0.1")
    p["conv_last"] = _conv(sd, "conv_last.1")
    return p, s


def to_jax(model, arch_encoder, arch_decoder):
    """The port model's (params, batch_stats) in the JAX zoo's tree; checks
    that every port key but the deep-supervision ones was read."""
    enc, dec = _Read(model.encoder.state_dict()), _Read(model.decoder.state_dict())
    if arch_encoder == "mobilenetv2dilated":
        ep, es = _mobilenet(enc)
    else:
        ep, es = convert_resnet_encoder(enc, basic=arch_encoder.startswith("resnet18"))
    dp, ds = _decoder(arch_decoder, dec)
    for sd in (enc, dec):
        left = {k for k in sd if "deepsup" not in k} - sd.read
        assert not left, sorted(left)[:10]
    if arch_decoder.startswith("c1"):  # the JAX zoo's C1 sits at the model's root
        return {"encoder": ep, **dp}, {"encoder": es, **ds}
    return {"encoder": ep, "decoder": dp}, {"encoder": es, "decoder": ds}


@torch.no_grad()
def calibrate_norms_(model, x, seed):
    """Seeded BatchNorm weights and biases, and running stats from one
    forward of `x`, each BatchNorm from its own input: per-channel means and
    the layer's variance about its mean, each times a seeded factor (the
    rule of test_torch_port_offline_hrnet.py, with the variance taken over
    the whole layer, since the PPM's 1x1 pooled maps have none per
    channel)."""
    g = torch.Generator().manual_seed(seed)

    def calibrate(m, inputs):
        t = inputs[0].float()
        m.running_mean.copy_(t.mean((0, 2, 3)) + 0.1 * torch.randn(t.shape[1], generator=g))
        m.running_var.copy_((t - t.mean()).square().mean()
                            * (torch.rand(t.shape[1], generator=g) + 0.5))

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


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _calibrated(factory, x, seed=1):
    return calibrate_norms_(seeded(factory, 0), _nchw(x), seed)


def _variables(params, stats):
    tree = jax.tree_util.tree_map
    return {"params": tree(jnp.asarray, params), "batch_stats": tree(jnp.asarray, stats)}


def _jax_model_outputs(arch_encoder, arch_decoder, params, stats, x, dtype):
    """The JAX zoo's softmax at HW and log-softmax, NCHW, at `dtype`
    (float64 under x64 with the float64 reading of its float32 casts)."""
    tree = jax.tree_util.tree_map
    with jax.enable_x64(dtype == jnp.float64):
        jmodel = jax_zoo.SegmentationModel(arch_encoder, arch_decoder, 150, dtype)
        variables = {"params": tree(lambda a: jnp.asarray(a, dtype), params),
                     "batch_stats": tree(lambda a: jnp.asarray(a, dtype), stats)}
        both = jax.jit(lambda v, x: (jmodel.apply(v, x, seg_size=HW), jmodel.apply(v, x)))
        return [np.asarray(a).transpose(0, 3, 1, 2)
                for a in both(variables, jnp.asarray(x, dtype))]


@pytest.mark.parametrize("arch_encoder,arch_decoder", [
    ("resnet18", "c1"), ("resnet50dilated", "ppm"), ("mobilenetv2dilated", "c1_deepsup")])
def test_model_matches_jax(arch_encoder, arch_decoder):
    """resnet18 + C1 and mobilenetv2dilated + C1 against JAX's float32 model.
    resnet50dilated + PPM through the float64 reading: both float64 models
    agree, and the port's float32 model lies within FLOAT32_NOISE of JAX's
    float64 one."""
    x = np.random.default_rng(0).standard_normal((1, *HW, 3), dtype=np.float32)
    model = _calibrated(lambda: semseg_zoo.SegmentationModel(arch_encoder, arch_decoder), x)
    params, stats = to_jax(model, arch_encoder, arch_decoder)
    with torch.no_grad():
        got_soft, got_log = model(_nchw(x), seg_size=HW).numpy(), model(_nchw(x)).numpy()
    stride = 32 if arch_encoder == "resnet18" else 8
    assert got_log.shape == (1, 150, HW[0] // stride, HW[1] // stride)
    if arch_encoder == "resnet50dilated":
        mp = pytest.MonkeyPatch()
        for module in (jax_hrnet, jax_zoo, jax_resize):
            mp.setattr(module, "jnp", _WidestJnp())
        try:
            want_soft, want_log = _jax_model_outputs(arch_encoder, arch_decoder, params, stats,
                                                     x, jnp.float64)
        finally:
            mp.undo()
        with torch.no_grad():
            model64, x64 = model.double(), _nchw(x).double()
            soft64, log64 = model64(x64, seg_size=HW).numpy(), model64(x64).numpy()
        np.testing.assert_allclose(log64, want_log, rtol=0, atol=FLOAT64_AGREE)
        np.testing.assert_allclose(soft64, want_soft, rtol=0, atol=FLOAT64_AGREE)
        log_tol, soft_tol = FLOAT32_NOISE
    else:
        want_soft, want_log = _jax_model_outputs(arch_encoder, arch_decoder, params, stats, x,
                                                 jnp.float32)
        log_tol, soft_tol = LOG_TOL, SOFT_TOL
    np.testing.assert_allclose(got_log, want_log, rtol=0, atol=log_tol)
    np.testing.assert_allclose(got_soft, want_soft, rtol=0, atol=soft_tol)
    # neither flat nor one-hot, so the comparison sees the logits
    assert 0.02 < want_soft.max() < 0.999 and want_soft.min() < 1e-3


def test_upernet_decoder_matches_jax():
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((1, 128 // s, 192 // s, c), dtype=np.float32)
             for s, c in ((4, 256), (8, 512), (16, 1024), (32, 2048))]
    decoder = seeded(lambda: semseg_zoo.UPerNet(150), 0)
    calibrate_norms_(decoder, [_nchw(f) for f in feats], 1)
    params, stats = _decoder("upernet", _Read(decoder.state_dict()))
    jdec = jax_zoo.UPerNetDecoder(150, dtype=jnp.float32)
    seg = (128, 192)

    @jax.jit
    def both(v, feats):
        return jdec.apply(v, feats, seg), jdec.apply(v, feats)

    want_soft, want_log = (np.asarray(a).transpose(0, 3, 1, 2)
                           for a in both(_variables(params, stats), feats))
    with torch.no_grad():
        y = decoder([_nchw(f) for f in feats]).double()
    got_log = torch.log_softmax(y, 1).numpy()
    got_soft = torch.softmax(semseg_zoo.resize_bilinear_half_pixel(y, seg), 1).numpy()
    assert got_log.shape == want_log.shape == (1, 150, 32, 48)
    np.testing.assert_allclose(got_log, want_log, rtol=0, atol=LOG_TOL)
    np.testing.assert_allclose(got_soft, want_soft, rtol=0, atol=SOFT_TOL)
    assert 0.02 < want_soft.max() < 0.999


def test_resnext_grouped_block_matches_jax():
    """resnext101's first block of layer2: 256 -> 256 planes in 32 groups,
    expansion 2, stride 2 with its downsample."""
    x = np.random.default_rng(3).standard_normal((1, 16, 24, 256), dtype=np.float32)
    block = semseg_zoo.ResNetEncoder("resnext101", dilated=False).layer2[0]
    block = calibrate_norms_(seeded(lambda: block, 0), _nchw(x), 1)
    sd = {f"layer2.0.{k}": v for k, v in block.state_dict().items()}
    params, stats = _bottleneck(sd, "layer2.0", has_downsample=True)
    jblock = jax_zoo.ResNetBlock(256, 2, 1, True, True, jnp.float32, 32, 2)
    want = np.asarray(jax.jit(jblock.apply)(_variables(params, stats), x)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = block(_nchw(x)).numpy()
    assert got.shape == want.shape == (1, 512, 8, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------- training

def _jax_step(params, stats, x, labels, dtype):
    tree = jax.tree_util.tree_map
    with jax.enable_x64(dtype == jnp.float64):
        jmodel = jax_zoo.SegmentationModel("resnet18dilated", "ppm", N_CLASSES, dtype)
        tx = jax_train.build_semseg_optimizer(BASE_LR, MAX_ITERS)
        p = tree(lambda a: jnp.asarray(a, dtype), params)
        jp, _, js, jm = jax_train.make_semseg_train_step(jmodel, tx)(
            p, tx.init(p), tree(lambda a: jnp.asarray(a, dtype), stats),
            jnp.asarray(x, dtype), jnp.asarray(labels))
        return tree(np.asarray, jp), tree(np.asarray, js), {k: float(v) for k, v in jm.items()}


@pytest.fixture(scope="module")
def steps():
    """{"port32", "port64", "jax32", "jax64"}: (params, stats, metrics) after
    one step of resnet18dilated + PPM, in the JAX tree; JAX's two steps run
    in threads beside the port's."""
    mp = pytest.MonkeyPatch()
    # torch's native CPU convolutions (oneDNN's float32 ones are less exact)
    mp.setattr(torch.backends.mkldnn, "enabled", False)
    for module in (jax_hrnet, jax_zoo, jax_resize):  # the float64 reading
        mp.setattr(module, "jnp", _WidestJnp())
    try:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 48, 48, 3), dtype=np.float32)
        labels = rng.integers(0, N_CLASSES, (2, 6, 6)).astype(np.int32)
        labels[:, 0] = -1
        labels[1, 3:5, 2:4] = -1

        def build():
            return semseg_zoo.SegmentationModel("resnet18dilated", "ppm", N_CLASSES)

        model = seeded(build, 0)
        params, stats = jax.tree_util.tree_map(
            np.array, to_jax(model, "resnet18dilated", "ppm"))
        jax_out, failures = {}, []

        def jax_step(dtype):
            try:
                jax_out[dtype] = _jax_step(params, stats, x, labels, dtype)
            except BaseException as e:  # raised again below
                failures.append(e)

        threads = [threading.Thread(target=jax_step, args=(d,))
                   for d in (jnp.float32, jnp.float64)]
        for thread in threads:
            thread.start()
        out = {}
        try:
            for dtype, key in ((torch.float32, "port32"), (torch.float64, "port64")):
                m = model if dtype == torch.float32 else seeded(build, 0).double()
                opt, sched = hrnet_train.build_semseg_optimizer(m, BASE_LR, MAX_ITERS)
                metrics = hrnet_train.make_semseg_train_step(m, opt, sched)(
                    _nchw(x).to(dtype), torch.from_numpy(labels))
                out[key] = (*to_jax(m, "resnet18dilated", "ppm"),
                            {k: float(v) for k, v in metrics.items()})
        finally:
            for thread in threads:
                thread.join()
        if failures:
            raise failures[0]
        out["jax32"], out["jax64"] = jax_out[jnp.float32], jax_out[jnp.float64]
        yield out
    finally:
        mp.undo()


def test_train_step_matches_jax(steps):
    got, want = steps["port32"][2], steps["jax32"][2]
    for k in ("loss", "acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert 0 < want["acc"] < 1 and np.isfinite(want["loss"])
    _hold(steps, 0)  # parameters
    _hold(steps, 1)  # BatchNorm running stats
    assert np.abs(steps["jax32"][1]["decoder"]["fusion_bn"]["mean"]).max() > 0


# ------------------------------------------------------------- checkpoints

def _csail_bn(prefix):
    return [f"{prefix}.{k}" for k in ("weight", "bias", "running_mean", "running_var",
                                      "num_batches_tracked")]


def _csail_encoder_keys(arch):
    """The keys of CSAIL's encoder module for `arch` (models.py's Resnet /
    ResnetDilated over resnet.py's ResNet, MobileNetV2Dilated over
    mobilenet.py's features[:-1])."""
    if arch == "mobilenetv2dilated":
        keys = ["features.0.0.weight"] + _csail_bn("features.0.1")
        k = 1
        for t, _, n, _ in semseg_zoo._MOBILENETV2:
            for _ in range(n):
                convs = (0, 3) if t == 1 else (0, 3, 6)
                for i in convs:
                    keys += [f"features.{k}.conv.{i}.weight"] + _csail_bn(f"features.{k}.conv.{i + 1}")
                k += 1
        return keys
    keys = []
    for i in (1, 2, 3):
        keys += [f"conv{i}.weight"] + _csail_bn(f"bn{i}")
    blocks = semseg_zoo.RESNET_LAYERS[arch.replace("dilated", "")]
    convs = 2 if arch.startswith("resnet18") else 3
    for s, n in enumerate(blocks, start=1):
        for b in range(n):
            for i in range(1, convs + 1):
                keys += [f"layer{s}.{b}.conv{i}.weight"] + _csail_bn(f"layer{s}.{b}.bn{i}")
            if b == 0:  # every first block changes the width or the stride
                keys += [f"layer{s}.{b}.downsample.0.weight"] + _csail_bn(f"layer{s}.{b}.downsample.1")
    return keys


def _csail_decoder_keys(arch):
    """The keys of CSAIL's C1DeepSup / PPMDeepsup (models.py)."""
    deepsup = (["cbr_deepsup.0.weight"] + _csail_bn("cbr_deepsup.1")
               + ["conv_last_deepsup.weight", "conv_last_deepsup.bias"])
    if arch == "c1_deepsup":
        return ["cbr.0.weight"] + _csail_bn("cbr.1") + ["conv_last.weight",
                                                        "conv_last.bias"] + deepsup
    keys = []
    for i in range(4):
        keys += [f"ppm.{i}.1.weight"] + _csail_bn(f"ppm.{i}.2")
    return (keys + ["conv_last.0.weight"] + _csail_bn("conv_last.1")
            + ["conv_last.4.weight", "conv_last.4.bias"] + deepsup)


@pytest.mark.parametrize("arch_encoder,arch_decoder", [
    ("resnet50dilated", "ppm_deepsup"), ("mobilenetv2dilated", "c1_deepsup")])
def test_csail_files_load_strictly(arch_encoder, arch_decoder, tmp_path):
    """A CSAIL pair with the port's shapes under CSAIL's keys (a batch
    counter a BatchNorm, the deep-supervision branch) loads with every
    tensor the file's; a key too many or too few raises."""
    with torch.device("meta"):  # values of no consequence here: a cheap fill, not a seeding
        model = semseg_zoo.SegmentationModel(arch_encoder, arch_decoder)
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for i, t in enumerate(model.state_dict().values()):
            t.copy_(torch.arange(i, i + t.numel()).reshape(t.shape) % 251)
    paths = []
    for part, keys in ((model.encoder, _csail_encoder_keys(arch_encoder)),
                       (model.decoder, _csail_decoder_keys(arch_decoder))):
        own = part.state_dict()
        sd = {k: own[k] if k in own else torch.tensor(7) for k in keys}
        assert set(own) == {k for k in keys if not k.endswith("num_batches_tracked")}
        paths.append(tmp_path / f"{len(paths)}.pth")
        torch.save(sd, paths[-1])
    loaded = semseg_zoo.load_segmentation_model(arch_encoder, arch_decoder, *map(str, paths))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    sd = torch.load(paths[1], weights_only=True)
    sd.pop("conv_last_deepsup.bias")
    with torch.device("meta"), pytest.raises(KeyError, match="conv_last_deepsup.bias"):
        load_checked(semseg_zoo.build_decoder(arch_decoder, 150, model.encoder.channels), sd,
                     str(paths[1]))
