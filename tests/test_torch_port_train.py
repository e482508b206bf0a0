"""Port parity, the training slice: BatchNorm in train mode, the optimizer,
and one full training step of mde_tpu_torch.train against mde_tpu.train on
the same weights and batch (CPU, float32).

The step runs B1 at full width with 128 bins on a batch of 2 at 320x416, the
smallest NYU-shaped input with the 129 mViT tokens the head needs (10 x 13 =
130). There the port takes the fused bins head and the chamfer kernel's
entry, both as their plain versions on the CPU; the JAX step runs its jnp
head and chunked chamfer, as `make_train_step` does on the CPU.

* Dropout: the two frameworks cannot share a mask, so the port's rate is set
  to 0 and flax's `nn.Dropout` is made an identity for the JAX step.
* Gradients: AdamW's first update is close to lr * sign(g), which would hide
  gradient errors, so the JAX step is given an optax transformation that
  keeps the gradients in its state and updates by zero, and the port's
  optimizer is watched for the gradients it receives before its clip.
* Tolerances: loss, silog and chamfer rtol 1e-4; the updated BN running
  stats rtol 1e-5 (atol 1e-6); each gradient tensor by relative norm error,
  held two ways (`test_step_gradients_match_jax`):
  - below its group's limit in GROUPS, set from the reading below with some
    room: 2e-2 for the encoder, 1e-2 for the decoder, 1e-3 for the mViT,
    1e-4 for conv_out;
  - float32 rounding explains the gap. The port's step runs once more in
    float64 (`f64_grads`); JAX's float32 gradient may be no more than 2.5x
    as far from it as the port's own float32 gradient is. A fault in the
    port's math moves the port's float64 gradient with it, and shows as a
    JAX error far above the port's own rounding.
  The reading (`pytest -s` prints it per group): the encoder blocks'
  tensors are a median 6.2e-3 from JAX's (largest 1.44e-2, an SE
  conv_reduce); the port's float32 is a median 5.2e-3 from its float64
  (largest 1.17e-2), JAX's float32 4.3e-3 (7.4e-3). The two float32 steps
  are each ~5e-3 from the exact gradient and ~sqrt(2) that from each other,
  as two independent roundings are: every train-mode BatchNorm backward
  (mean-subtracted sums that cancel) grows the rounding on the way down.
  In the mViT the port's float32 is 2.4e-4 from its float64 and JAX's
  7e-6: the port rounds more there, and its math agrees.
  ROUNDING_FLOOR covers the tensors whose errors are a few float32
  roundings (the regressor: JAX 6.2e-6, the port 1.7e-6).

bf16: the port's step under bf16 autocast against JAX's `build_model(dtype=
bfloat16)` step (`bf16_steps`; JAX's CPU step takes the XLA head, the port
the plain version of the tensor-core kernels, `PlainBf16Head`), each held
against the port's float64 step on the same weights: per parameter group,
the relative norm error of the group's gradients, the port's at most
BF16_RATIO (2) x JAX's plus BF16_FLOOR (1e-3), with JAX's below BF16_AGREE
(0.45) so that a zero gradient fails; the loss against the float32 loss, at
most 2 x JAX's plus BF16_LOSS_FLOOR (2e-3).
  The bf16 step runs on the seeded weights with their ReLU and LeakyReLU
corners lifted (`_lift_corners`). At the seed's own weights a bf16 forward
is ~15 % off float64 by the decoder (a few roundings a block, over 23
blocks), so ~10 % of the decoder's LeakyReLUs and the mViT's ReLUs see the
other side of their corner, each such unit's gradient changing 100-fold;
both sides' bf16 gradients were then 75-100 % off float64 in the encoder
and decoder (JAX 0.92 in the blocks), so that reading could not fail a zero
gradient. With the corners lifted the float32 step's errors fall from ~5e-3
to ~1e-5. The reading there (`pytest -s -k bf16`, two threads), port / JAX:
encoder blocks 0.290 / 0.310, encoder BN 0.258 / 0.322, decoder 0.026 /
0.040, mViT transformer 0.015 / 0.034, regressor 0.0047 / 0.0037, conv_out
0.080 / 0.067 (conv_out reads 0.053 with four threads: its bf16 error
depends on the order of the sums); the loss 1.5e-4 (port) and 7.3e-5 (JAX)
from float32. The two round in different places: flax keeps BatchNorm in
float32 and rounds its output to bf16, autocast runs it in bf16. Run with
BatchNorm in float32, the port's decoder and mViT errors rise by ~40 %
(decoder 0.026 to 0.037, transformer 0.017 to 0.024) and the regressor's
falls (0.0050 to 0.0037), so the port keeps autocast's BatchNorm.
"""

import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mde_tpu.models import build_model as jax_build_model
from mde_tpu.parallel import make_mesh
from mde_tpu.train import optim as jax_optim
from mde_tpu.train.loop import make_train_step as jax_make_train_step
from mde_tpu.train.state import TrainState as JaxTrainState
from mde_tpu_torch.checkpoint import state_dict_from_flax
from mde_tpu_torch.kernels import bins_head
from mde_tpu_torch.models import UnetAdaptiveBins
from mde_tpu_torch.models.mvit import dropout
from mde_tpu_torch.models.norm import BatchNorm2d
from mde_tpu_torch.train import (OneCycleAdamW, create_train_state, make_loss_fn,
                                 make_train_step, onecycle_lr_schedule,
                                 onecycle_momentum_schedule)
from float64_convs import depthwise_as_taps
from test_torch_port_models import flax_variables

torch.set_num_threads(2)


def _args(**kw):
    base = dict(n_bins=128, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b1", use_semantics=None,
                use_instance_segmentation=None, insertion_point="before-attn",
                image="rgb", w_chamfer=0.1, chamfer=True, epochs=25, lr=0.000357,
                wd=0.1, div_factor=25.0, final_div_factor=100.0, same_lr=False,
                encoder_lr_factor=1.0, seed=0, use_fused_head=True,
                use_pallas_chamfer=True, compute_dtype="float32", accum_steps=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


# --- BatchNorm -------------------------------------------------------------

@pytest.mark.parametrize("eps,flax_momentum", [(1e-3, 0.99), (1e-5, 0.9)],
                         ids=["encoder", "decoder"])
def test_batchnorm_train_mode_matches_flax(eps, flax_momentum):
    """12 values per channel (batch 2 of 2x3): torch's own update would move
    the running variance by 12/11 of flax's variance term."""
    rng = np.random.default_rng(0)
    x = (2 + 3 * rng.standard_normal((2, 2, 3, 8))).astype(np.float32)
    mean0 = rng.uniform(-0.1, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    bn = flax.linen.BatchNorm(use_running_average=False, epsilon=eps, momentum=flax_momentum)
    want, mutated = bn.apply({"params": {"scale": scale, "bias": bias},
                              "batch_stats": {"mean": mean0, "var": var0}},
                             jnp.asarray(x), mutable=["batch_stats"])
    want_stats = mutated["batch_stats"]

    def port(cls):
        m = cls(8, eps=eps, momentum=1 - flax_momentum).train()
        m.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                           "running_mean": torch.from_numpy(mean0),
                           "running_var": torch.from_numpy(var0.copy()),
                           "num_batches_tracked": torch.tensor(0)})
        return m, m(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))

    m, got = port(BatchNorm2d)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), want_stats["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), want_stats["var"], rtol=1e-5, atol=1e-6)
    assert int(m.num_batches_tracked) == 1
    plain, _ = port(torch.nn.BatchNorm2d)
    assert not np.allclose(plain.running_var.numpy(), want_stats["var"], rtol=1e-5, atol=1e-6)


# --- Dropout ---------------------------------------------------------------

def test_dropout_draws_from_the_given_generator():
    """flax semantics (keep with 1 - rate, scale the kept by 1 / (1 - rate)),
    reproducible from a seeded generator, identity outside training."""
    x = torch.ones(64, 1000)
    a = dropout(x, 0.1, True, torch.Generator().manual_seed(3))
    b = dropout(x, 0.1, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.9))
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert dropout(x, 0.1, False) is x


def test_encoder_train_mode_draws_nothing_at_random():
    """Stochastic depth is 0, the JAX default: two train-mode forwards of the
    encoder under different global seeds give the same features."""
    from mde_tpu_torch.models.efficientnet import EfficientNetEncoder
    torch.manual_seed(0)
    encoder = EfficientNetEncoder("efficientnet-b1").train()
    x = torch.randn(2, 3, 64, 64)
    torch.manual_seed(1)
    a = encoder(x)
    torch.manual_seed(2)
    b = encoder(x)
    assert len(a) == 14
    for fa, fb in zip(a, b):
        assert torch.equal(fa, fb)


# --- Optimizer -------------------------------------------------------------

def test_onecycle_schedules_match_jax():
    """lr and beta1 for every step of a 100-step schedule. The JAX schedules
    run in float32, the port's in float64 (as torch's OneCycleLR): near the
    end of the cycle the float32 cos term is off by ~1e-7 of max_lr, hence
    the atol."""
    total, max_lr = 100, 3.57e-4
    jax_lr = jax_optim.onecycle_lr_schedule(max_lr, total, div_factor=25, final_div_factor=100)
    jax_b1 = jax_optim.onecycle_momentum_schedule(total)
    lr = onecycle_lr_schedule(max_lr, total, div_factor=25, final_div_factor=100)
    b1 = onecycle_momentum_schedule(total)
    steps = jnp.arange(total)
    np.testing.assert_allclose([lr(s) for s in range(total)], np.asarray(jax_lr(steps)),
                               rtol=1e-6, atol=1e-7 * max_lr)
    np.testing.assert_allclose([b1(s) for s in range(total)], np.asarray(jax_b1(steps)),
                               rtol=1e-6)


class _TwoGroups(torch.nn.Module):
    def __init__(self, enc, dec):
        super().__init__()
        self.encoder = torch.nn.Module()
        self.encoder.w = torch.nn.Parameter(torch.from_numpy(enc.copy()))
        self.decoder = torch.nn.Module()
        self.decoder.w = torch.nn.Parameter(torch.from_numpy(dec.copy()))


@pytest.mark.parametrize("factor", [1.0, 0.1])
def test_adamw_clip_updates_match_optax(factor):
    """Three updates on the same gradients (global norm ~7, so the clip to
    0.1 acts) against the optax chain of the JAX `build_optimizer`. torch's
    clip divides by norm + 1e-6 and optax's by norm: the clip scales differ
    by ~1.4e-7 relative, and AdamW's m / sqrt(v) cancels a common scale but
    for eps, so the parameters agree to float32 rounding (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    enc = rng.standard_normal(16).astype(np.float32)
    dec = rng.standard_normal(16).astype(np.float32)
    grads = [rng.standard_normal((2, 16)).astype(np.float32) for _ in range(3)]
    args = _args(encoder_lr_factor=factor)

    params = {"encoder": {"w": jnp.asarray(enc)}, "decoder": {"w": jnp.asarray(dec)}}
    tx, _ = jax_optim.build_optimizer(params, args, steps_per_epoch=4)
    opt_state = tx.init(params)
    model = _TwoGroups(enc, dec)
    opt = OneCycleAdamW(model, args, steps_per_epoch=4)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({"encoder": {"w": jnp.asarray(g[0])},
                                        "decoder": {"w": jnp.asarray(g[1])}}, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        model.encoder.w.grad = torch.from_numpy(g[0].copy())
        model.decoder.w.grad = torch.from_numpy(g[1].copy())
        opt.step(step)
        for name in ("encoder", "decoder"):
            np.testing.assert_allclose(getattr(model, name).w.detach().numpy(),
                                       np.asarray(params[name]["w"]), rtol=1e-6, atol=1e-8)


# --- One training step -----------------------------------------------------

def _grad_keeper():
    """optax transformation that updates by zero and keeps the gradients."""
    def init(params):  # numpy: an eager jnp op would compile once per shape
        return {"grads": jax.tree_util.tree_map(np.zeros_like, params)}

    def update(updates, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), {"grads": updates}

    return optax.GradientTransformation(init, update)


def _nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _port_model(params, stats, fused_head):
    model = UnetAdaptiveBins(n_bins=128, min_val=1e-3, max_val=10.0,
                             encoder_name="efficientnet-b1", fused_head=fused_head)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    for m in model.modules():
        if hasattr(m, "dropout"):
            m.dropout = 0.0
    return model


@pytest.fixture(scope="module")
def step_inputs():
    params, stats = flax_variables(n_bins=128, seed=6)
    rng = np.random.default_rng(7)
    image = rng.standard_normal((2, 320, 416, 3)).astype(np.float32)
    depth = (rng.random((2, 320, 416, 1)) * 9.9 + 0.05).astype(np.float32)
    depth[:, :16] = 0.0  # not valid: below min_depth and the chamfer threshold
    return params, stats, image, depth


def _f64_step(params, stats, image, depth):
    """The port's loss and gradients of the step on these weights and batch,
    in float64: the plain head and the chunked chamfer, with the `.float()`
    casts of the model and the losses (there to lift bf16 under autocast)
    leaving float64 tensors as they are, and the depthwise convolutions as
    tap sums (`float64_convs.py`: the same float64 function, ~10 % less
    time)."""
    model = _port_model(params, stats, fused_head=False).double().train()
    to_float = torch.Tensor.float
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.Tensor, "float",
               lambda self, *a, **k: self if self.dtype == torch.float64 else to_float(self, *a, **k))
    try:
        with depthwise_as_taps():
            loss, _, _ = make_loss_fn(_args(use_pallas_chamfer=False))(
                model, {"image": _nchw(image).double(), "depth": _nchw(depth).double()})
            loss.backward()
    finally:
        mp.undo()
    return loss.item(), {k: torch.zeros_like(p) if p.grad is None else p.grad
                         for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def f64_grads(step_inputs):
    """The port's float64 gradients on the step's weights and batch."""
    return _f64_step(*step_inputs)[1]


@pytest.fixture(scope="module")
def one_step(step_inputs):
    params, stats, image, depth = step_inputs
    args = _args()

    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        model = jax_build_model(args, dtype=jnp.float32)
        state = JaxTrainState.create(apply_fn=model.apply, params=params, tx=_grad_keeper(),
                                     batch_stats=stats)
        step = jax_make_train_step(model, args, None, None,
                                   make_mesh("1", devices=jax.devices()[:1]))
        new_state, metrics = step(state, {"image": jnp.asarray(image),
                                          "depth": jnp.asarray(depth)}, jax.random.PRNGKey(0))
        want_metrics = {k: float(v) for k, v in metrics.items()}
        want_grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state["grads"])
        want_stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)
    finally:
        mp.undo()

    port = _port_model(params, stats, fused_head=True)
    train_state = create_train_state(port, args, steps_per_epoch=10)
    seen = {}
    optimizer_step = train_state.optimizer.step

    def watch(step_index):
        seen.update({k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for k, p in port.named_parameters()})
        return optimizer_step(step_index)

    train_state.optimizer.step = watch
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    calls = []
    fused = bins_head.fused_bins_head
    mp = pytest.MonkeyPatch()
    mp.setattr("mde_tpu_torch.models.unet_adaptive_bins.fused_bins_head",
               lambda *a: calls.append(a[0].shape) or fused(*a))
    try:
        train_state, metrics = make_train_step(args)(train_state, {
            "image": _nchw(image), "depth": _nchw(depth)})
    finally:
        mp.undo()
    return dict(want_metrics=want_metrics, want_grads=state_dict_from_flax(want_grads, stats),
                want_stats=state_dict_from_flax(params, want_stats),
                metrics={k: v.item() for k, v in metrics.items()}, grads=seen,
                before=before, after={k: v.clone() for k, v in port.state_dict().items()},
                state=train_state, calls=calls)


@pytest.mark.parametrize("metric", ["loss", "silog", "chamfer"])
def test_step_metrics_match_jax(one_step, metric):
    got, want = one_step["metrics"][metric], one_step["want_metrics"][metric]
    assert np.isfinite(got) and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


# group: (parameter name prefix, limit of a tensor's relative norm error)
GROUPS = {"encoder_stem": ("encoder.original_model.conv_stem", 2e-2),
          "encoder_blocks": ("encoder.original_model.blocks.", 2e-2),
          "encoder_head": ("encoder.original_model.conv_head", 2e-2),
          "encoder_bn": ("encoder.original_model.bn", 2e-2),
          "decoder": ("decoder.", 1e-2),
          "mvit_transformer": ("adaptive_bins_layer.patch_transformer.", 1e-3),
          "mvit_conv3x3": ("adaptive_bins_layer.conv3x3.", 1e-3),
          "mvit_regressor": ("adaptive_bins_layer.regressor.", 1e-3),
          "conv_out": ("conv_out.", 1e-4)}
ROUNDING_RATIO = 2.5  # JAX float32 to port float64, over port float32 to port float64
ROUNDING_FLOOR = 1e-5  # a few float32 roundings: below it either side may lead


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("group", list(GROUPS))
def test_step_gradients_match_jax(one_step, f64_grads, group):
    """Relative norm error of every gradient tensor of the group against
    JAX's, below the group's limit and explained by float32 rounding (module
    docstring). A tensor whose true gradient is zero (a conv bias before a
    train-mode BN, a BN whose output reaches the loss only through later
    BNs, the encoder's last BN) holds float32 noise on both sides: both must
    stay below 1e-6 of the largest gradient norm."""
    prefix, limit = GROUPS[group]
    names = [k for k in one_step["grads"] if k.startswith(prefix)]
    assert names
    floor = 1e-6 * max(np.linalg.norm(g.numpy()) for g in one_step["want_grads"].values()
                       if g.dtype == torch.float32)
    reading = []
    for name in names:
        got = one_step["grads"][name].double().numpy()
        want = one_step["want_grads"][name].double().numpy()
        exact = f64_grads[name].numpy()
        assert got.shape == want.shape == exact.shape, name
        if np.linalg.norm(want) < floor:
            assert np.linalg.norm(got) < floor, name
            continue
        err, own, theirs = _rel(got, want), _rel(got, exact), _rel(want, exact)
        reading.append((err, own, theirs))
        assert err < limit, f"{name}: relative norm error {err:.2e} against JAX"
        assert theirs <= ROUNDING_RATIO * own + ROUNDING_FLOOR, (
            f"{name}: JAX's float32 gradient is {theirs:.2e} from the port's float64 one, "
            f"the port's float32 {own:.2e}")
    r = np.array(reading)
    print(f"{group}: {len(r)} tensors; relative norm error, median / largest: port f32 vs "
          f"JAX f32 {np.median(r[:, 0]):.2e} / {r[:, 0].max():.2e}; port f32 vs port f64 "
          f"{np.median(r[:, 1]):.2e} / {r[:, 1].max():.2e}; JAX f32 vs port f64 "
          f"{np.median(r[:, 2]):.2e} / {r[:, 2].max():.2e}")


def test_step_bn_running_stats_match_jax(one_step):
    names = [k for k in one_step["after"] if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 77  # 69 BatchNorms in the B1 encoder, 8 in the decoder
    for name in names:
        np.testing.assert_allclose(one_step["after"][name].numpy(),
                                   one_step["want_stats"][name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        assert not torch.equal(one_step["after"][name], one_step["before"][name]), name


def test_step_takes_the_fused_head_and_updates_every_parameter(one_step):
    """One fused-head call per step, no kernel launch on the CPU; the
    optimizer moved every parameter and counted the step."""
    assert one_step["calls"] == [torch.Size([2, 128, 160, 208])]
    assert one_step["state"].step == 1
    for name, p in one_step["state"].model.named_parameters():
        assert not torch.equal(p.detach(), one_step["before"][name]), name


def test_loss_fn_gradients_reach_the_head(one_step):
    """make_loss_fn exposes the loss on its own: its gradients for the head
    after the step are finite and non-zero."""
    model = one_step["state"].model
    loss, l_dense, l_chamfer = make_loss_fn(_args())(model, {
        "image": torch.zeros(1, 3, 320, 416), "depth": torch.full((1, 1, 320, 416), 2.0)})
    model.zero_grad()
    loss.backward()
    grad = model.conv_out[0].weight.grad
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    assert torch.isfinite(l_dense) and torch.isfinite(l_chamfer)


# --- bf16 autocast against JAX's bfloat16 model ----------------------------

def _lift_corners(params):
    """The seeded weights with every ReLU and LeakyReLU input lifted off the
    corner: +3 on the decoder's BatchNorm biases (a BN output is about unit
    normal) and the mViT feed-forwards' first bias, +3, +10, +10 on the
    regressor's three biases (their inputs grow to ~3 after the first)."""
    params = jax.tree_util.tree_map(np.copy, params)
    for up in ("up1", "up2", "up3", "up4"):
        for bn in ("bn_a", "bn_b"):
            params["decoder"][up][bn]["bias"] += 3.0
    bins = params["adaptive_bins_layer"]
    for layer in range(4):
        bins["patch_transformer"][f"layer_{layer}"]["linear1"]["bias"] += 3.0
    for i, lift in enumerate((3.0, 10.0, 10.0)):
        bins[f"regressor_{i}"]["bias"] += lift
    return params


@pytest.fixture(scope="module")
def bf16_steps(step_inputs):
    """The port's step under bf16 autocast and JAX's `build_model(dtype=
    bfloat16)` step, on the step's batch and the weights with their corners
    lifted (`_lift_corners`), with the port's float32 loss and float64 loss
    and gradients there."""
    params, stats, image, depth = step_inputs
    params = _lift_corners(params)
    args = _args(compute_dtype="bfloat16")
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        model = jax_build_model(args, dtype=jnp.bfloat16)
        state = JaxTrainState.create(apply_fn=model.apply, params=params, tx=_grad_keeper(),
                                     batch_stats=stats)
        step = jax_make_train_step(model, args, None, None,
                                   make_mesh("1", devices=jax.devices()[:1]))
        new_state, metrics = step(state, {"image": jnp.asarray(image),
                                          "depth": jnp.asarray(depth)}, jax.random.PRNGKey(0))
        jax_loss = float(metrics["loss"])
        jax_grads = state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, new_state.opt_state["grads"]), stats)
    finally:
        mp.undo()

    batch = {"image": _nchw(image), "depth": _nchw(depth)}
    port = _port_model(params, stats, fused_head=True).train()
    loss, _, _ = make_loss_fn(args)(port, batch)
    loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in port.named_parameters()}
    with torch.no_grad():
        f32_loss, _, _ = make_loss_fn(_args())(_port_model(params, stats, True).train(), batch)
    f64_loss, f64 = _f64_step(params, stats, image, depth)
    return dict(loss=loss.item(), grads=grads, jax_loss=jax_loss, jax_grads=jax_grads,
                f32_loss=f32_loss.item(), f64_loss=f64_loss, f64_grads=f64)


BF16_RATIO = 2.0  # the port's bf16 error over JAX's, against the float64 step
BF16_FLOOR = 1e-3  # relative norm error: a bf16 rounding of the group's values
BF16_LOSS_FLOOR = 2e-3  # relative: half of bf16's 2**-8 relative spacing
BF16_AGREE = 0.45  # JAX's bf16 error against the float64 step: below 1/BF16_RATIO


def test_bf16_step_loss_as_close_to_float32_as_jax(bf16_steps):
    """The bf16 loss of each side against the port's float32 loss (itself
    ~1e-6 relative from float64): the port's error at most BF16_RATIO x
    JAX's plus BF16_LOSS_FLOOR."""
    exact = bf16_steps["f32_loss"]
    assert abs(exact - bf16_steps["f64_loss"]) <= 1e-5 * exact
    own = abs(bf16_steps["loss"] - exact) / exact
    theirs = abs(bf16_steps["jax_loss"] - exact) / exact
    print(f"bf16 loss: port {bf16_steps['loss']:.7f} ({own:.2e} from float32), JAX "
          f"{bf16_steps['jax_loss']:.7f} ({theirs:.2e}), float32 {exact:.7f}")
    assert own <= BF16_RATIO * theirs + BF16_LOSS_FLOOR, (own, theirs)


@pytest.mark.parametrize("group", list(GROUPS))
def test_bf16_step_gradients_as_close_to_float64_as_jax(bf16_steps, group):
    """Per parameter group, the relative norm error of the group's bf16
    gradients against the port's float64 step: the port's may be no more
    than BF16_RATIO x JAX's plus BF16_FLOOR, and JAX's is below BF16_AGREE,
    so that the float64 step is the function JAX's bf16 step computes and a
    zero gradient (error 1) fails the first bound."""
    prefix, _ = GROUPS[group]
    f64 = bf16_steps["f64_grads"]
    names = [k for k in f64 if k.startswith(prefix)]
    assert names

    def flat(grads):
        return np.concatenate([grads[k].double().numpy().ravel() for k in names])

    exact = flat(f64)
    own, theirs = _rel(flat(bf16_steps["grads"]), exact), _rel(flat(bf16_steps["jax_grads"]),
                                                                 exact)
    print(f"bf16 {group}: {len(names)} tensors; relative norm error against the port's "
          f"float64 step: port {own:.3e}, JAX {theirs:.3e}")
    assert theirs < BF16_AGREE, (own, theirs)
    assert own <= BF16_RATIO * theirs + BF16_FLOOR, (own, theirs)
