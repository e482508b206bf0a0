"""Port parity, the training step's options: `--remat encoder` and
`--accum_steps` (CPU, float32).

The model is B1 noAdaBins (no mViT, so no dropout and no chamfer) at 64x96
on a batch of 4: the encoder and the decoder at full width, and the smallest
input that reaches every stage. Weights come from `seeded_variables`.

* Remat: the port checkpoints each encoder block and runs its forward again
  in the backward, with the BatchNorms' running stats left as they are the
  second time (models/norm.py). Against the same step without remat the
  loss and the gradients are held at rtol 2e-4, the tolerance of JAX's own
  `test_remat_encoder_matches_no_remat`, and the BN buffers exactly: on the
  CPU they come out bit for bit equal. Against JAX's remat step (its
  gradients kept by an optax transformation that updates by zero, as in
  `test_torch_port_train.py`): loss rtol 1e-4, BN running stats rtol 1e-5
  (atol 1e-6), and each gradient tensor through a float64 reading: the
  port's step runs once more in float64 without remat (`f64_grads`); the
  port's float32 remat gradient may be no more than ROUNDING_RATIO (2) times
  as far from it as JAX's float32 remat gradient is, plus ROUNDING_FLOOR,
  and JAX's must be within AGREE (1e-2, relative norm) of it, so that the
  float64 step is the right function. The reading (`pytest -s`): the port's
  float32 is the closer in every tensor, JAX's error up to ~5x the port's
  (decoder.conv3.bias 5.1e-4 against 1.1e-4), the largest JAX error 2.3e-3.
* `--accum_steps 2` against the manual mean of the two micro-batches'
  gradients, with BN stats threaded through the two forwards, as
  `tests/test_train.py::test_accum_steps_matches_manual_mean_gradient` holds
  the JAX step: gradients rtol 1e-6 (atol 1e-9), the same buffers, the mean
  loss.
"""

import copy
import types

import numpy as np
import pytest
import torch

from float64_convs import depthwise_as_taps
from mde_tpu_torch.checkpoint import state_dict_from_flax
from mde_tpu_torch.models import build_model
from mde_tpu_torch.train import create_train_state, make_loss_fn, make_train_step

torch.set_num_threads(2)

HW, BATCH = (64, 96), 4
ROUNDING_RATIO = 2.0  # the port's float32 error over JAX's, against float64
ROUNDING_FLOOR = 1e-5
AGREE = 1e-2  # JAX's float32 gradient against the port's float64 one


def _args(**kw):
    base = dict(n_bins=8, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b1-noAdaBins", use_semantics=None,
                use_instance_segmentation=None, insertion_point="before-attn",
                image="rgb", w_chamfer=0.1, chamfer=True, epochs=25, lr=0.000357,
                wd=0.1, div_factor=25.0, final_div_factor=100.0, same_lr=False,
                encoder_lr_factor=1.0, seed=0, use_fused_head=True,
                use_pallas_chamfer=True, compute_dtype="float32", accum_steps=1,
                remat="none")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def inputs():
    from mde_tpu.models import build_model as jax_build_model
    from test_torch_port_models import seeded_variables
    params, stats = seeded_variables(jax_build_model(_args()), [(1, *HW, 3)], seed=11)
    rng = np.random.default_rng(12)
    image = rng.standard_normal((BATCH, *HW, 3)).astype(np.float32)
    depth = (rng.random((BATCH, *HW, 1)) * 9.9 + 0.05).astype(np.float32)
    depth[:, :6] = 0.0  # not valid
    return params, stats, image, depth


def _nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _port_step(inputs, **kw):
    """One port training step; returns the loss, the gradients the optimizer
    received (zeros where the loss does not reach), and the state_dict
    before and after."""
    params, stats, image, depth = inputs
    args = _args(**kw)
    model = build_model(args)
    model.load_state_dict(state_dict_from_flax(params, stats, args.encoder_name), strict=True)
    state = create_train_state(model, args, steps_per_epoch=10)
    seen = {}
    real = state.optimizer.step

    def watch(step_index):
        seen.update({k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for k, p in model.named_parameters()})
        return real(step_index)

    state.optimizer.step = watch
    before = copy.deepcopy(model.state_dict())
    state, metrics = make_train_step(args)(state, {"image": _nchw(image), "depth": _nchw(depth)})
    return dict(loss=metrics["loss"].item(), grads=seen, before=before,
                after=copy.deepcopy(model.state_dict()))


@pytest.fixture(scope="module")
def plain_step(inputs):
    return _port_step(inputs)


@pytest.fixture(scope="module")
def remat_step(inputs):
    return _port_step(inputs, remat="encoder")


def _largest(grads):
    return max(g.abs().max().item() for g in grads.values())


def test_remat_checkpoints_every_encoder_block(inputs):
    """The remat forward goes through torch.utils.checkpoint once per block,
    only when it records gradients in training mode."""
    model = build_model(_args(remat="encoder")).train()
    calls = []
    real = torch.utils.checkpoint.checkpoint
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.utils.checkpoint, "checkpoint",
               lambda *a, **k: calls.append(1) or real(*a, **k))
    try:
        x = torch.zeros(1, 3, *HW)
        model(x)
        n_blocks = sum(len(stage) for stage in model.encoder.original_model.blocks)
        assert len(calls) == n_blocks == 23
        with torch.no_grad():
            model(x)
        model.eval()(x)
        assert len(calls) == n_blocks
    finally:
        mp.undo()


def test_remat_loss_matches_no_remat(plain_step, remat_step):
    np.testing.assert_allclose(remat_step["loss"], plain_step["loss"], rtol=2e-4)


def test_remat_gradients_match_no_remat(plain_step, remat_step):
    assert remat_step["grads"].keys() == plain_step["grads"].keys()
    atol = 2e-4 * _largest(plain_step["grads"])
    for name, want in plain_step["grads"].items():
        torch.testing.assert_close(remat_step["grads"][name], want, rtol=2e-4, atol=atol,
                                   msg=name)


def test_remat_moves_bn_buffers_once(plain_step, remat_step):
    """Every running mean and variance, and num_batches_tracked (one more
    than before), equal to the step without remat."""
    names = [k for k in plain_step["after"] if "running_" in k or "num_batches" in k]
    assert len(names) == 3 * 77
    for name in names:
        assert torch.equal(remat_step["after"][name], plain_step["after"][name]), name
        if "num_batches" in name:
            assert int(remat_step["after"][name]) == int(remat_step["before"][name]) + 1
        else:
            assert not torch.equal(remat_step["after"][name], remat_step["before"][name]), name


@pytest.fixture(scope="module")
def jax_remat_step(inputs):
    import jax
    import jax.numpy as jnp
    import optax

    from mde_tpu.models import build_model as jax_build_model
    from mde_tpu.parallel import make_mesh
    from mde_tpu.train.loop import make_train_step as jax_make_train_step
    from mde_tpu.train.state import TrainState as JaxTrainState

    params, stats, image, depth = inputs
    args = _args(remat="encoder")

    def init(p):
        return {"grads": jax.tree_util.tree_map(np.zeros_like, p)}

    def update(updates, state, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), {"grads": updates}

    model = jax_build_model(args, dtype=jnp.float32)
    state = JaxTrainState.create(apply_fn=model.apply, params=params, batch_stats=stats,
                                 tx=optax.GradientTransformation(init, update))
    step = jax_make_train_step(model, args, None, None,
                               make_mesh("1", devices=jax.devices()[:1]))
    new_state, metrics = step(state, {"image": jnp.asarray(image), "depth": jnp.asarray(depth)},
                              jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state["grads"])
    new_stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)
    return dict(loss=float(metrics["loss"]),
                grads=state_dict_from_flax(grads, stats, args.encoder_name),
                after=state_dict_from_flax(params, new_stats, args.encoder_name))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_remat_step_matches_jax_remat_step(remat_step, jax_remat_step, f64_grads):
    """Loss and BN stats against JAX's remat step; each gradient tensor held
    through the float64 reading (module docstring)."""
    np.testing.assert_allclose(remat_step["loss"], jax_remat_step["loss"], rtol=1e-4)
    for name, want in jax_remat_step["after"].items():
        if "running_" in name:
            np.testing.assert_allclose(remat_step["after"][name].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    floor = 1e-6 * max(np.linalg.norm(g.numpy()) for g in f64_grads.values())
    reading = []
    for name, exact in f64_grads.items():
        got = remat_step["grads"][name].double().numpy()
        want = jax_remat_step["grads"][name].double().numpy()
        exact = exact.numpy()
        if np.linalg.norm(exact) < floor:
            assert np.linalg.norm(got) < floor and np.linalg.norm(want) < floor, name
            continue
        own, theirs = _rel(got, exact), _rel(want, exact)
        reading.append((own, theirs, name))
    print("remat step, relative norm error against the port's float64 step: "
          + ", ".join(f"{n} port {o:.2e} JAX {t:.2e}" for o, t, n in sorted(reading, key=lambda r: r[1] / r[0])[-6:]))
    for own, theirs, name in reading:
        assert own <= ROUNDING_RATIO * theirs + ROUNDING_FLOOR, (name, own, theirs)
        assert theirs < AGREE, (name, own, theirs)


def test_accum_steps_matches_manual_mean_gradient(inputs):
    """--accum_steps 2 equals the mean of the two micro-batches' gradients
    (BN running stats threaded through the two forwards), applied once."""
    params, stats, image, depth = inputs
    got = _port_step(inputs, accum_steps=2)

    args = _args()
    model = build_model(args).train()
    model.load_state_dict(state_dict_from_flax(params, stats, args.encoder_name), strict=True)
    loss_fn = make_loss_fn(args)
    losses, grads = [], []
    for half in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
        model.zero_grad(set_to_none=True)
        loss, _, _ = loss_fn(model, {"image": _nchw(image[half]), "depth": _nchw(depth[half])})
        loss.backward()
        losses.append(loss.item())
        grads.append({k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for k, p in model.named_parameters()})
    np.testing.assert_allclose(got["loss"], np.mean(losses), rtol=1e-6)
    for name, g in got["grads"].items():
        torch.testing.assert_close(g, (grads[0][name] + grads[1][name]) / 2, rtol=1e-6,
                                   atol=1e-9, msg=name)
    for name, buf in model.named_buffers():
        assert torch.equal(got["after"][name], buf), name


@pytest.fixture(scope="module")
def f64_grads(inputs):
    params, stats, image, depth = inputs
    args = _args()
    model = build_model(args).double().train()
    model.load_state_dict(state_dict_from_flax(params, stats, args.encoder_name), strict=True)
    to_float = torch.Tensor.float
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.Tensor, "float",
               lambda self, *a, **k: self if self.dtype == torch.float64 else to_float(self, *a, **k))
    try:
        with depthwise_as_taps():  # float64_convs.py: the same function, faster
            loss, _, _ = make_loss_fn(args)(model, {"image": _nchw(image).double(),
                                                    "depth": _nchw(depth).double()})
            loss.backward()
    finally:
        mp.undo()
    return {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()}
