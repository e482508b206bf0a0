"""Port parity, the detector's training loss: mde_tpu_torch.offline's
`CascadeMaskRCNN.compute_losses` (full Swin-B, FPN, RPN, the three cascade
stages and mask heads) against mde_tpu.offline's, and the port's AdamW
recipe against `detection_data.py`'s (CPU, float32; bfloat16 in
tests/test_torch_port_offline_losses_bf16.py).

The JAX model is seeded from the port's state_dict through its own
converter (`convert_detector`, with the two layout fixes of
tests/test_torch_port_offline_detector.py); the file is handed to it in
memory. Both sides take JAX's sampler draws: the eight uniform vectors that
`compute_losses` draws from its key (the RPN's positives and negatives,
then each stage's), computed here from the same key splits and handed to
the port's `uniform`.

At 64x96 with `num_samples` 64 and 8 GT slots (5 valid, of them one with
a box-shaped mask and one of 1 px), tolerances: every loss rtol 1e-4 (the
JAX side under jax.jit); the bbox heads' BatchNorm stats after the step
(flax's update, over the 64 sampled rois) within 1e-5 of each tensor's
largest magnitude. One AdamW step of the port's `detector_optimizer`
(warmup ratio 1, so the first update runs at the base lr) lowers the total
on the same draws. The no-decay set equals JAX's `detector_param_labels`
key for key: each port tensor is filled with its own index, converted, and
each flax leaf read back to the port key it came from. The lr schedule
equals JAX's at steps 0, 250, 500, 27 and 33 epochs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.offline import cascade_rcnn as jax_rcnn
from mde_tpu.offline import detection_data as jax_data
from mde_tpu.offline.swin_convert import convert_detector
from mde_tpu_torch.offline import cascade_rcnn, detection_data
from mde_tpu_torch.offline.layers import seeded

torch.set_num_threads(4)

HW = (64, 96)
NUM_SAMPLES = 64
G, G_VALID = 8, 5
# the RPN's anchors over the four FPN levels and the pooled fifth (1 x 2)
N_ANCHORS = sum(3 * (HW[0] // s) * (HW[1] // s) for s in (4, 8, 16, 32)) + 3 * 1 * 2


def _to_jax_layout(sd):
    """The two tensors `convert_detector` maps without mmdet's reordering."""
    sd = dict(sd)
    for k in list(sd):
        if k.endswith("shared_fcs.0.weight"):  # (C, 7, 7) columns -> (7, 7, C)
            w = sd[k]
            sd[k] = w.reshape(w.shape[0], -1, 7, 7).permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        elif k.endswith("upsample.weight"):
            sd[k] = torch.flip(sd[k], dims=(2, 3))
    return sd


def _convert(sd):
    """convert_detector on an in-memory state_dict."""
    real_load = torch.load
    torch.load = lambda *a, **k: {"state_dict": sd}
    try:
        return convert_detector("in-memory")
    finally:
        torch.load = real_load


def _gt():
    rng = np.random.default_rng(0)
    h, w = HW
    xy = rng.uniform(0, [w - 20, h - 20], (G, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(6, 40, (G, 2))], 1).astype(np.float32)
    boxes[:, 2] = np.minimum(boxes[:, 2], w)
    boxes[:, 3] = np.minimum(boxes[:, 3], h)
    boxes[4] = [30.0, 20.0, 31.0, 21.0]  # 1 px
    labels = rng.integers(0, 100, G).astype(np.int32)
    valid = np.arange(G) < G_VALID
    masks = np.zeros((G, h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for g in range(G_VALID):
        x1, y1, x2, y2 = boxes[g]
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        inside = ((xx + 0.5 - cx) / max(rx, 0.5)) ** 2 + ((yy + 0.5 - cy) / max(ry, 0.5)) ** 2 <= 1
        masks[g] = inside if g != 1 else ((xx >= x1) & (xx < x2) & (yy >= y1) & (yy < y2))
    return boxes, labels, valid, masks


def _jax_draws(key, n_anchors):
    """compute_losses' draws: rng -> (rng, r_rpn), r_rpn -> (r1, r2); then
    per stage rng -> (rng, r_s), r_s -> (r1, r2). Stage 0 samples the 1,000
    proposals and the GTs, the later stages the previous stage's rois and
    the GTs."""
    out = []
    for n in (n_anchors, cascade_rcnn.NUM_PROPOSALS + G, NUM_SAMPLES + G, NUM_SAMPLES + G):
        key, r = jax.random.split(key)
        r1, r2 = jax.random.split(r)
        out += [jax.random.uniform(r1, (n,)), jax.random.uniform(r2, (n,))]
    return [torch.from_numpy(np.array(d)) for d in out]


def _jax_losses(jmodel, variables, x, boxes, labels, valid, masks, key):
    """JAX's compute_losses under jax.jit -> ({loss: float}, batch_stats)."""

    @jax.jit
    def losses_fn(v, x, b, l, m, gm, k):
        return jmodel.apply(v, x, b, l, m, gm, k, HW, NUM_SAMPLES,
                            method=jax_rcnn.CascadeMaskRCNN.compute_losses,
                            mutable=["batch_stats"])

    want, mutated = losses_fn(variables, x, boxes, labels, valid, masks.astype(np.float32), key)
    return {k: float(v) for k, v in want.items()}, mutated["batch_stats"]


@pytest.fixture(scope="module")
def setup():
    model = seeded(lambda: cascade_rcnn.CascadeMaskRCNN(), 0)
    params, stats = _convert(_to_jax_layout(model.state_dict()))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    x = np.random.default_rng(1).standard_normal((1, *HW, 3), dtype=np.float32)
    boxes, labels, valid, masks = _gt()
    key = jax.random.PRNGKey(3)
    want, want_stats = _jax_losses(jax_rcnn.CascadeMaskRCNN(num_classes=100, dtype=jnp.float32),
                                   variables, x, boxes, labels, valid, masks, key)
    draws = _jax_draws(key, N_ANCHORS)
    return model, params, want, want_stats, draws, _torch_inputs(x, boxes, labels, valid, masks)


def _torch_inputs(x, boxes, labels, valid, masks):
    return (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(boxes),
            torch.from_numpy(labels).long(), torch.from_numpy(valid), torch.from_numpy(masks))


def _uniform(draws):
    it = iter(draws)

    def uniform(n):
        d = next(it)
        assert d.shape == (n,), (d.shape, n)
        return d
    return uniform


@pytest.fixture(scope="module")
def port_losses(setup):
    """The port's compute_losses in training mode on JAX's draws, its graph
    kept (the AdamW test takes its backward), and the state_dict before it."""
    model, _, _, _, draws, inputs = setup
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    return model.compute_losses(*inputs, _uniform(draws), HW, NUM_SAMPLES), before


def test_losses_and_bn_stats_match_jax(setup, port_losses):
    model, _, want, want_stats, draws, inputs = setup
    got = {k: float(v.detach()) for k, v in port_losses[0].items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert all(np.isfinite(list(got.values()))) and got["s0_mask"] > 0 and got["rpn_reg"] > 0
    for i, head in enumerate(model.roi_head.bbox_head):
        for j in range(4):
            bn = head.shared_convs[j].bn
            jstats = want_stats[f"bbox_head{i}"][f"shared_bn{j}"]
            for mine, theirs in ((bn.running_mean, jstats["mean"]), (bn.running_var, jstats["var"])):
                theirs = np.asarray(theirs)
                err = np.abs(mine.numpy() - theirs).max() / np.abs(theirs).max()
                assert err <= 1e-5, (i, j, err)


def test_one_optimizer_step_lowers_the_total(setup, port_losses):
    """AdamW on the gradients of port_losses' total (the test above reads
    the same forward), then the total again on the same draws."""
    model, _, _, _, draws, inputs = setup
    losses, before = port_losses
    model.train()
    opt, sched = detection_data.detector_optimizer(model, base_lr=1e-5, warmup_ratio=1.0)
    try:
        total = losses["total"]
        opt.zero_grad()
        total.backward()
        opt.step()
        sched.step()
        with torch.no_grad():
            after = model.compute_losses(*inputs, _uniform(draws), HW, NUM_SAMPLES)["total"]
        assert float(after) < float(total.detach()), (float(after), float(total.detach()))
    finally:
        model.load_state_dict(before)


def test_no_decay_set_equals_jax_key_for_key(setup):
    model, params, *_ = setup
    keys = list(_to_jax_layout(model.state_dict()))
    stamped = {k: torch.full(model.state_dict()[k].shape, float(i)) for i, k in enumerate(keys)}
    stamped_params, _ = _convert(stamped)
    labels = jax_data.detector_param_labels(stamped_params)
    leaves = jax.tree_util.tree_leaves_with_path(stamped_params)
    label_leaves = dict(jax.tree_util.tree_leaves_with_path(labels))
    jax_no_decay = set()
    seen = set()
    for path, leaf in leaves:
        first = np.asarray(leaf).reshape(-1)[0]
        assert (np.asarray(leaf) == first).all()
        key = keys[int(first)]
        seen.add(key)
        if label_leaves[path] == "no_decay":
            jax_no_decay.add(key)
    params_names = {n for n, _ in model.named_parameters()}
    assert seen == params_names  # every parameter maps to one flax leaf
    assert detection_data.no_decay_names(model) == jax_no_decay
    assert any("relative_position_bias_table" in k for k in jax_no_decay)
    assert any(k.endswith("bn.weight") for k in jax_no_decay)


def test_lr_schedule_equals_jax():
    spe = 37
    jsched = jax_data.detector_lr_schedule(1e-4, spe)
    sched = detection_data.detector_lr_schedule(1e-4, spe)
    for step in (0, 250, 500, 27 * spe, 33 * spe):
        assert sched(step) == float(jsched(jnp.asarray(step, jnp.int32))), step
    model = torch.nn.Linear(2, 2)
    opt, lr = detection_data.detector_optimizer(model, steps_per_epoch=spe)
    seen = []
    for step in range(3):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        lr.step()
    np.testing.assert_allclose(seen, [float(jsched(jnp.asarray(s))) for s in range(3)],
                               rtol=1e-7)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.05, 0.0]
