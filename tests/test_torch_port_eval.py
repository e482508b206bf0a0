"""Port parity, validation and the cue training step: mde_tpu_torch.ops.metrics,
`make_eval_step`, `validate` and `make_train_step` with cues against mde_tpu's
(CPU, float32).

* Metrics: `compute_errors_masked` rtol 1e-5 (float32 sums in other orders;
  the JAX side under `jax.jit`, one compile instead of one per op);
  `compute_errors` and `eval_mask` equal.
* Eval step and validate, configuration A (tests/test_torch_port_cues.py) at
  320x416 with a 480x640 GT, so the prediction is resized: per-image SILog
  and metrics rtol 1e-4, a1-a3 atol 1e-3 (a pixel at a ratio threshold may
  flip with the depth's last digits, and one pixel of the eigen crop is
  4.2e-6 of it; the depth itself agrees to rtol 1e-4, atol 2e-3 m, as in the
  forward tests). The eval step computes in `--compute_dtype`: at bfloat16
  its convolutions run in bf16 and its metrics agree with JAX's bf16 eval
  step within BF16_METRIC_RTOL (5e-3), set from JAX's own bf16 error.
* One training step, configuration B (cues before the mViT) at 320x416,
  batch 2, as tests/test_torch_port_train.py holds the no-cue step: dropout
  off on both sides, JAX's gradients kept by an optax transformation that
  updates by zero, loss, silog and chamfer rtol 1e-4, and each gradient
  tensor held by its relative norm error below its group's limit and within
  ROUNDING_RATIO of the port's own float32 rounding against its float64 step.
  The CueMLPs feed the mViT only, so they take the mViT's limit.
"""

import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.cues import InstanceEmbedder as JaxInstanceEmbedder
from mde_tpu.cues import SemanticsEmbedder as JaxSemanticsEmbedder
from mde_tpu.models import build_model as jax_build_model
from mde_tpu.ops import metrics as jax_metrics
from mde_tpu.parallel import make_mesh
from mde_tpu.train.loop import make_eval_step as jax_make_eval_step
from mde_tpu.train.loop import make_train_step as jax_make_train_step
from mde_tpu.train.loop import validate as jax_validate
from mde_tpu.train.state import TrainState as JaxTrainState
from mde_tpu_torch.checkpoint import state_dict_from_flax
from mde_tpu_torch.cues import InstanceEmbedder, SemanticsEmbedder
from mde_tpu_torch.kernels import bins_head
from mde_tpu_torch.ops import metrics
from mde_tpu_torch.train import create_train_state, make_eval_step, make_loss_fn
from mde_tpu_torch.train import make_train_step, validate
from float64_convs import depthwise_as_taps
from test_torch_port_cues import CPU, config_args, jax_config, port_model, raw_cues
from test_torch_port_models import nchw
from test_torch_port_train import (GROUPS, ROUNDING_FLOOR, ROUNDING_RATIO, _grad_keeper,
                                   _rel)

torch.set_num_threads(2)

HW, GT_HW = (320, 416), (480, 640)
# bf16 validation metrics, relative: JAX's own bf16 metrics lie 8.3e-7 (silog)
# to 7.2e-4 (sq_rel) from its float32 step, whose rounding is orders below
# bf16's; the port's bf16 step (autocast: bf16 BatchNorms, where flax's
# compute in float32) lies 1.6e-6 to 2.2e-3 from JAX's (measured, config A)
BF16_METRIC_RTOL = 5e-3


# --- metrics ---------------------------------------------------------------

def _gt_pred(seed, shape=(3, 37, 53)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.05, 9.95, shape).astype(np.float32)
    pred = (gt * rng.uniform(0.6, 1.6, shape)).astype(np.float32)
    mask = rng.random(shape) < 0.7
    mask[:, :4] = False
    gt[:, :4] = 0.0  # masked pixels may hold anything
    return gt, pred, mask


def test_compute_errors_masked_matches_jax():
    """Per image (the eval step's dim=(-2, -1)), against JAX's vmapped form."""
    gt, pred, mask = _gt_pred(0)
    want = jax.jit(jax.vmap(jax_metrics.compute_errors_masked))(
        jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(mask))
    got = metrics.compute_errors_masked(torch.from_numpy(gt), torch.from_numpy(pred),
                                        torch.from_numpy(mask), dim=(-2, -1))
    assert list(got) == list(metrics.METRIC_NAMES) == list(jax_metrics.METRIC_NAMES)
    for name in metrics.METRIC_NAMES:
        assert got[name].shape == (3,), name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   err_msg=name)
    whole = metrics.compute_errors_masked(torch.from_numpy(gt), torch.from_numpy(pred),
                                          torch.from_numpy(mask))
    want_whole = jax.jit(jax_metrics.compute_errors_masked)(gt, pred, mask)
    for name in metrics.METRIC_NAMES:
        np.testing.assert_allclose(whole[name].item(), float(want_whole[name]), rtol=1e-5)


def test_compute_errors_matches_jax():
    gt, pred, mask = _gt_pred(1)
    want = jax_metrics.compute_errors(gt[mask].astype(np.float64), pred[mask].astype(np.float64))
    got = metrics.compute_errors(gt[mask].astype(np.float64), pred[mask].astype(np.float64))
    assert got == want


@pytest.mark.parametrize("dataset,hw", [("nyu", (480, 640)), ("kitti", (352, 1216))])
@pytest.mark.parametrize("crop", ["garg", "eigen", "none"])
def test_eval_mask_matches_jax(dataset, hw, crop):
    kw = dict(garg_crop=crop == "garg", eigen_crop=crop == "eigen")
    np.testing.assert_array_equal(metrics.eval_mask(hw, dataset, **kw),
                                  jax_metrics.eval_mask(hw, dataset, **kw))


# --- the eval step and validate (configuration A) ---------------------------

def _depth(rng, n):
    depth = rng.uniform(0.05, 9.95, (n, *GT_HW, 1)).astype(np.float32)
    depth[:, 100:180, 200:330] = 0.0  # invalid: below min_depth_eval
    return depth


@pytest.fixture(scope="module")
def eval_config():
    """Configuration A: the JAX eval step, jitted once for batches of 2, and
    the port's, on the same weights; three batches of raw maps. float32 on
    both sides: the port's eval step computes in `--compute_dtype`, whose
    parser default is bfloat16, and the JAX model is built in float32."""
    args, model, params, stats, _ = jax_config("A", HW, 20, "--compute_dtype", "float32", n=2)
    rng = np.random.default_rng(21)
    batches = []
    for valid in ([True, True], [True, False], [True, True]):
        batch = raw_cues(rng, 2, HW, args.use_instance_segmentation)
        batch["image"] = rng.standard_normal((2, *HW, 3)).astype(np.float32)
        batch["depth"] = _depth(rng, 2)
        batch["has_valid_depth"] = np.array(valid)
        batches.append(batch)
    jax_step = jax_make_eval_step(model, args, JaxSemanticsEmbedder(args),
                                  JaxInstanceEmbedder(args))
    step = make_eval_step(args, SemanticsEmbedder(args, CPU), InstanceEmbedder(args, CPU))
    return dict(args=args, params=params, stats=stats, batches=batches, jax_step=jax_step,
                step=step, port=port_model(args, params, stats))


def _port_batch(batch):
    return {k: torch.from_numpy(v) if k == "has_valid_depth" else nchw(v)
            for k, v in batch.items()}


def _assert_metrics_close(got, want):
    for name in metrics.METRIC_NAMES:
        atol = 1e-3 if name in ("a1", "a2", "a3") else 0.0
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def validated(eval_config):
    """Both validates over the three batches, each step's outputs kept, and
    the shapes the port's fused head was called with."""
    c = eval_config
    state = types.SimpleNamespace(params=c["params"], batch_stats=c["stats"])
    jax_steps, steps, calls = [], [], []

    def jax_step(*a):
        jax_steps.append(c["jax_step"](*a))
        return jax_steps[-1]

    def step(*a):
        steps.append(c["step"](*a))
        return steps[-1]

    fused = bins_head.fused_bins_head
    mp = pytest.MonkeyPatch()
    mp.setattr("mde_tpu_torch.models.unet_adaptive_bins.fused_bins_head",
               lambda *a: calls.append(a[0].shape) or fused(*a))
    try:
        want = jax_validate(c["args"], jax_step, state, c["batches"])
        got = validate(c["args"], step, c["port"], [_port_batch(b) for b in c["batches"]])
    finally:
        mp.undo()
    return dict(want=want, got=got, jax_steps=jax_steps, steps=steps, calls=calls)


def test_eval_step_matches_jax(validated):
    """Per-image SILog and metrics of the first batch of 2, the prediction
    resized from 160x208 to the 480x640 GT and cropped to eigen; one fused
    head call a batch."""
    assert validated["calls"] == [torch.Size([2, 128, 160, 208])] * 3
    (want_si, want), (si, got, pred) = validated["jax_steps"][0], validated["steps"][0]
    assert pred.shape == (2, 1, 160, 208) and pred.dtype == torch.float32
    assert si.shape == (2,) and np.all(np.isfinite(si.numpy()))
    np.testing.assert_allclose(si.numpy(), np.asarray(want_si), rtol=1e-4)
    for name in metrics.METRIC_NAMES:
        assert got[name].shape == (2,) and np.all(np.isfinite(got[name].numpy())), name
    _assert_metrics_close({k: v.numpy() for k, v in got.items()},
                          {k: np.asarray(v) for k, v in want.items()})


def test_validate_matches_jax(validated):
    """Three batches of 2, one sample marked invalid: five samples averaged."""
    (want, want_si), (got, got_si) = validated["want"], validated["got"]
    assert len(validated["steps"]) == len(validated["jax_steps"]) == 3
    assert got_si.count == want_si.count == 5
    np.testing.assert_allclose(got_si.get_value(), want_si.get_value(), rtol=1e-4)
    assert set(got) == set(want)
    _assert_metrics_close(got, want)


def test_validate_skips_batches_without_valid_depth(eval_config):
    """A batch with no valid sample never reaches the step; with none at all
    every metric is NaN, as in JAX."""
    c = eval_config
    batch = dict(c["batches"][0], has_valid_depth=np.array([False, False]))
    step = lambda *a: pytest.fail("the step ran on a batch with no valid sample")  # noqa: E731
    got, si = validate(c["args"], step, c["port"], [_port_batch(batch)])
    assert si.count == 0 and all(np.isnan(v) for v in got.values())
    assert sorted(got) == sorted(metrics.METRIC_NAMES)


def test_eval_step_runs_in_the_compute_dtype(eval_config):
    """The eval step of `make_eval_step(args, ...)`, as main_train builds it:
    at --compute_dtype bfloat16 every convolution of the model computes in
    bf16 (a forward hook sees bf16 outputs; autocast casts the inputs inside
    the call; the JAX driver's one model computes in bf16), at float32 in
    float32. The bf16 metrics of the first batch agree with JAX's bf16
    eval step on the same weights and frames within BF16_METRIC_RTOL, set
    from JAX's own bf16 error: its distance from its float32 step, whose
    rounding is orders below bf16's. A float32 eval step at bfloat16 fails
    the dtype check."""
    c = eval_config
    model, batch = c["port"], [_port_batch(c["batches"][0])]
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, out: seen.append(out.dtype))
             for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    got = {}
    try:
        for dtype in ("float32", "bfloat16"):
            args = types.SimpleNamespace(**{**vars(c["args"]), "compute_dtype": dtype})
            seen.clear()
            got[dtype], _ = validate(args, make_eval_step(args, *_embedders(args)), model, batch)
            assert set(seen) == {getattr(torch, dtype)}, (dtype, set(seen))
    finally:
        for h in hooks:
            h.remove()
    args = types.SimpleNamespace(**{**vars(c["args"]), "compute_dtype": "bfloat16"})
    jax_step = jax_make_eval_step(jax_build_model(args, dtype=jnp.bfloat16), args,
                                  JaxSemanticsEmbedder(args), JaxInstanceEmbedder(args))
    state = types.SimpleNamespace(params=c["params"], batch_stats=c["stats"])
    want, _ = jax_validate(args, jax_step, state, c["batches"][:1])
    want32, _ = jax_validate(c["args"], c["jax_step"], state, c["batches"][:1])
    for name in metrics.METRIC_NAMES:
        jax_err = abs(want[name] - want32[name]) / abs(want32[name])
        err = abs(got["bfloat16"][name] - want[name]) / abs(want[name])
        print(f"{name}: port bf16 against JAX bf16 {err:.2e}, JAX bf16 against float32 "
              f"{jax_err:.2e}")
        assert jax_err <= BF16_METRIC_RTOL and err <= BF16_METRIC_RTOL, name
    _assert_metrics_close(got["float32"], want32)


# --- one training step with cues (configuration B) --------------------------

def _train_args(**kw):
    args = config_args("B", "--compute_dtype", "float32")
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def step_inputs():
    args, model, params, stats, raw = jax_config("B", HW, 30, n=2)
    rng = np.random.default_rng(31)
    raw["depth"] = (rng.random((2, *HW, 1)) * 9.9 + 0.05).astype(np.float32)
    raw["depth"][:, :16] = 0.0
    return params, stats, raw


def _port_cue_model(params, stats, args):
    model = port_model(args, params, stats)
    for m in model.modules():
        if hasattr(m, "dropout"):
            m.dropout = 0.0
    return model


def _embedders(args):
    return SemanticsEmbedder(args, CPU), InstanceEmbedder(args, CPU)


@pytest.fixture(scope="module")
def f64_cue_grads(step_inputs):
    """The port's gradients of the same loss in float64 (plain head and
    chamfer; `.float()` leaves float64 tensors as they are)."""
    params, stats, raw = step_inputs
    args = _train_args(use_fused_head=False, use_pallas_chamfer=False)
    model = _port_cue_model(params, stats, args).double().train()
    to_float = torch.Tensor.float
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.Tensor, "float", lambda self, *a, **k: (
        self if self.dtype == torch.float64 else to_float(self, *a, **k)))
    try:
        batch = {k: nchw(v) for k, v in raw.items()}
        batch["image"], batch["depth"] = batch["image"].double(), batch["depth"].double()
        sem, inst = _embedders(args)
        with depthwise_as_taps():  # float64_convs.py: the same function, faster
            loss, _, _ = make_loss_fn(  # float64 cues, as the model is
                args, lambda *a: [t.double() for t in sem(*a)],
                lambda *a: [t.double() for t in inst(*a)])(model, batch)
            loss.backward()
    finally:
        mp.undo()
    return {k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def cue_step(step_inputs):
    params, stats, raw = step_inputs
    args = _train_args()
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        model = jax_build_model(args, dtype=jnp.float32)
        state = JaxTrainState.create(apply_fn=model.apply, params=params, tx=_grad_keeper(),
                                     batch_stats=stats)
        step = jax_make_train_step(model, args, JaxSemanticsEmbedder(args),
                                   JaxInstanceEmbedder(args),
                                   make_mesh("1", devices=jax.devices()[:1]))
        new_state, m = step(state, {k: jnp.asarray(v) for k, v in raw.items()},
                            jax.random.PRNGKey(0))
        want_metrics = {k: float(v) for k, v in m.items()}
        want_grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state["grads"])
    finally:
        mp.undo()

    port = _port_cue_model(params, stats, args)
    train_state = create_train_state(port, args, steps_per_epoch=10)
    seen = {}
    optimizer_step = train_state.optimizer.step

    def watch(step_index):
        seen.update({k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for k, p in port.named_parameters()})
        return optimizer_step(step_index)

    train_state.optimizer.step = watch
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    train_state, metrics_ = make_train_step(args, *_embedders(args))(
        train_state, {k: nchw(v) for k, v in raw.items()})
    return dict(want_metrics=want_metrics,
                want_grads=state_dict_from_flax(want_grads, stats, args.encoder_name),
                metrics={k: v.item() for k, v in metrics_.items()}, grads=seen,
                before=before, model=port)


@pytest.mark.parametrize("metric", ["loss", "silog", "chamfer"])
def test_cue_step_metrics_match_jax(cue_step, metric):
    got, want = cue_step["metrics"][metric], cue_step["want_metrics"][metric]
    assert np.isfinite(got) and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


CUE_GROUPS = {**GROUPS, "cue_mlps": (("semantics_areas_fc.", "instance_areas_fc."), 1e-3)}


@pytest.mark.parametrize("group", list(CUE_GROUPS))
def test_cue_step_gradients_match_jax(cue_step, f64_cue_grads, group):
    """As tests/test_torch_port_train.py::test_step_gradients_match_jax, with
    the CueMLPs as one more group."""
    prefix, limit = CUE_GROUPS[group]
    names = [k for k in cue_step["grads"] if k.startswith(prefix)]
    assert names
    floor = 1e-6 * max(np.linalg.norm(g.numpy()) for g in cue_step["want_grads"].values()
                       if g.dtype == torch.float32)
    reading = []
    for name in names:
        got = cue_step["grads"][name].double().numpy()
        want = cue_step["want_grads"][name].double().numpy()
        exact = f64_cue_grads[name].numpy()
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
          f"{np.median(r[:, 1]):.2e} / {r[:, 1].max():.2e}")


def test_cue_step_updates_every_parameter(cue_step):
    """The CueMLPs and the 198-channel mViT convs among them."""
    model = cue_step["model"]
    assert model.adaptive_bins_layer.conv3x3.weight.shape[1] == 198
    names = [n for n, _ in model.named_parameters()]
    assert {"semantics_areas_fc.0.weight", "instance_areas_fc.2.bias"} <= set(names)
    for name, p in model.named_parameters():
        assert not torch.equal(p.detach(), cue_step["before"][name]), name
