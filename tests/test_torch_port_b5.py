"""Port parity, EfficientNet-B5: the parser's default encoder, and the one
`params/args_test_nyu.txt` (and the two other params files that name no
encoder) builds. B5 noAdaBins at 64x96, batch 2 (CPU, float32): the B5
encoder at its full width and depth (39 MBConv blocks, stages of 40 to 512
channels, a 2,048-channel head) and the decoder at B5's skip widths, with no
mViT, so the input can be this small. Weights from `seeded_variables`.

* Eval-mode forward against JAX's: rtol 1e-4, atol 1e-4 (the tolerance of
  `test_torch_port_models.py`).
* One training step against JAX's `make_train_step` (its gradients kept by
  an optax transformation that updates by zero): loss rtol 1e-4, BN running
  stats rtol 1e-5 (atol 1e-6), and each gradient tensor through the float64
  reading of `test_torch_port_step_options.py`: the port's float32 error
  against its float64 step at most ROUNDING_RATIO (2) x JAX's plus
  ROUNDING_FLOOR, and JAX's within AGREE_B5 (5e-2, relative norm) of it, so
  that the float64 step is the right function. The reading (`pytest -s`):
  both float32 steps are a median ~7e-3 from float64 and at most 1.4e-2
  (port) and 1.5e-2 (JAX), in the SE convs of stage 2: B5's 39 train-mode
  BatchNorm backwards grow the float32 rounding further than B1's 23.
  The seeded conv3 bias is lifted by 3 m: with the seed's own bias most
  pixels sat at the ReLU's corner (depth = ReLU(conv3) + 1e-4), where a
  float32 rounding decides whether a pixel passes a gradient, and the two
  float32 steps then differed from float64 by O(1) in every tensor while
  their losses agreed to 1e-4.

Cost: JAX's step (trace, compile and run, ~17 s on two cores) runs in a
thread while the port's two steps and JAX's eval forward run, and the port's
models are built on the meta device and take the seeded tensors as they are.
"""

import threading
import types

import numpy as np
import pytest
import torch

from test_torch_port_step_options import ROUNDING_FLOOR, ROUNDING_RATIO, _rel

torch.set_num_threads(2)

HW, BATCH = (64, 96), 2
AGREE_B5 = 5e-2  # JAX's float32 gradient against the port's float64 one


def _args(**kw):
    base = dict(n_bins=8, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b5-noAdaBins", use_semantics=None,
                use_instance_segmentation=None, insertion_point="before-attn",
                image="rgb", w_chamfer=0.1, chamfer=True, epochs=25, lr=0.000357,
                wd=0.1, div_factor=25.0, final_div_factor=100.0, same_lr=False,
                encoder_lr_factor=1.0, seed=0, use_fused_head=True,
                use_pallas_chamfer=True, compute_dtype="float32", accum_steps=1,
                remat="none")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def inputs():
    from mde_tpu.models import build_model as jax_build_model
    from test_torch_port_models import seeded_variables
    params, stats = seeded_variables(jax_build_model(_args()), [(1, *HW, 3)], seed=31)
    # depth = ReLU(conv3) + 1e-4: a bias of 3 m keeps every pixel on the ReLU's
    # live side, where a float32 rounding cannot switch a pixel's gradient
    params["decoder"]["conv3"]["bias"] = params["decoder"]["conv3"]["bias"] + 3.0
    rng = np.random.default_rng(32)
    image = rng.standard_normal((BATCH, *HW, 3)).astype(np.float32)
    depth = (rng.random((BATCH, *HW, 1)) * 9.9 + 0.05).astype(np.float32)
    depth[:, :6] = 0.0
    return params, stats, image, depth


def _port_model(inputs):
    from mde_tpu_torch.checkpoint import state_dict_from_flax
    from mde_tpu_torch.models import build_model
    params, stats = inputs[:2]
    with torch.device("meta"):  # no initialisation: every tensor comes from the trees
        model = build_model(_args())
    model.load_state_dict(state_dict_from_flax(params, stats, "efficientnet-b5-noAdaBins"),
                          strict=True, assign=True)
    return model


def test_b5_builds_the_jax_widths(inputs):
    encoder = _port_model(inputs).encoder.original_model
    assert sum(len(stage) for stage in encoder.blocks) == 39
    assert encoder.conv_stem.weight.shape[0] == 48
    assert encoder.conv_head.weight.shape[:2] == (2048, 512)


def test_b5_forward_matches_jax(inputs, steps):
    image = inputs[2]
    with torch.no_grad():
        edges, got = _port_model(inputs).eval()(_nchw(image))
    assert edges is None
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), steps["jax_forward"],
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def steps(inputs):
    """JAX's float32 step and eval forward, and the port's float32 and
    float64 steps. JAX's step runs in a thread: its compile and its run
    leave the interpreter to the port's steps and JAX's eval forward."""
    import jax
    import jax.numpy as jnp
    import optax

    from mde_tpu.models import build_model as jax_build_model
    from mde_tpu.parallel import make_mesh
    from mde_tpu.train.loop import make_train_step as jax_make_train_step
    from mde_tpu.train.state import TrainState as JaxTrainState
    from mde_tpu_torch.checkpoint import state_dict_from_flax
    from mde_tpu_torch.train import make_loss_fn

    params, stats, image, depth = inputs
    args = _args()
    name = args.encoder_name
    out, failures = {}, []

    def init(p):
        return {"grads": jax.tree_util.tree_map(np.zeros_like, p)}

    def update(updates, state, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), {"grads": updates}

    def jax_step():
        try:
            model = jax_build_model(args, dtype=jnp.float32)
            state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                         batch_stats=stats,
                                         tx=optax.GradientTransformation(init, update))
            new_state, metrics = jax_make_train_step(
                model, args, None, None, make_mesh("1", devices=jax.devices()[:1]))(
                state, {"image": jnp.asarray(image), "depth": jnp.asarray(depth)},
                jax.random.PRNGKey(0))
            out.update(
                jax_loss=float(metrics["loss"]),
                jax_grads=state_dict_from_flax(
                    jax.tree_util.tree_map(np.asarray, new_state.opt_state["grads"]), stats,
                    name),
                jax_after=state_dict_from_flax(
                    params, jax.tree_util.tree_map(np.asarray, new_state.batch_stats), name))
        except BaseException as e:  # raised again in the fixture
            failures.append(e)

    thread = threading.Thread(target=jax_step)
    thread.start()
    try:
        loss_fn = make_loss_fn(args)
        for dtype in (torch.float32, torch.float64):
            model = _port_model(inputs).to(dtype).train()
            to_float = torch.Tensor.float
            mp = pytest.MonkeyPatch()
            if dtype == torch.float64:
                mp.setattr(torch.Tensor, "float", lambda self, *a, **k: (
                    self if self.dtype == torch.float64 else to_float(self, *a, **k)))
            try:
                loss, _, _ = loss_fn(model, {"image": _nchw(image).to(dtype),
                                             "depth": _nchw(depth).to(dtype)})
                loss.backward()
            finally:
                mp.undo()
            key = "f32" if dtype == torch.float32 else "f64"
            out[key] = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach()
                        for k, p in model.named_parameters()}
            if dtype == torch.float32:
                out["loss"] = loss.item()
                out["after"] = model.state_dict()
        model = jax_build_model(args)
        _, forward = jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x,
                                                         train=False))(params, stats, image)
        out["jax_forward"] = np.asarray(forward)
    finally:
        thread.join()
    if failures:
        raise failures[0]
    return out


def test_b5_step_loss_matches_jax(steps):
    np.testing.assert_allclose(steps["loss"], steps["jax_loss"], rtol=1e-4)


def test_b5_step_bn_running_stats_match_jax(steps):
    names = [k for k in steps["jax_after"] if "running_" in k]
    assert len(names) == 2 * (2 + 2 * 3 + 3 * 36 + 8)  # stem, head; 3 + 36 blocks; decoder
    for k in names:
        np.testing.assert_allclose(steps["after"][k].numpy(), steps["jax_after"][k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_b5_step_gradients_match_jax(steps):
    floor = 1e-6 * max(np.linalg.norm(g.numpy()) for g in steps["f64"].values())
    reading = []
    for name, exact in steps["f64"].items():
        got, want = steps["f32"][name].double().numpy(), steps["jax_grads"][name].double().numpy()
        exact = exact.numpy()
        if np.linalg.norm(exact) < floor:
            assert np.linalg.norm(got) < floor and np.linalg.norm(want) < floor, name
            continue
        own, theirs = _rel(got, exact), _rel(want, exact)
        reading.append((own, theirs, name))
        assert own <= ROUNDING_RATIO * theirs + ROUNDING_FLOOR, (name, own, theirs)
        assert theirs < AGREE_B5, (name, own, theirs)
    r = np.array([(o, t) for o, t, _ in reading])
    print(f"B5 step, {len(r)} tensors, relative norm error against the port's float64 step, "
          f"median / largest: port {np.median(r[:, 0]):.2e} / {r[:, 0].max():.2e}, JAX "
          f"{np.median(r[:, 1]):.2e} / {r[:, 1].max():.2e}")
