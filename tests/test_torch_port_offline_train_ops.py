"""Port parity, the detector's training machinery: every function of
mde_tpu_torch.offline.detection_train against mde_tpu.offline.detection_train
(CPU, float32), the JAX side in one jax.jit.

Inputs from seeded numpy, built to reach the edge cases: boxes that copy a
GT (IoU ties between boxes, claimed by match_low_quality), two identical GTs
(ties between GTs: the first wins), invalid GT slots, boxes outside the
image (ignored by the RPN), and a sampler asked for more rois than it has
candidates. The sampler takes JAX's own draws (the two uniforms that
`random_sample` draws from its key).

Tolerances: values rtol 1e-6 (atol 1e-7 where a value is ~0); the
gradients of the CE, BCE, SmoothL1 and GIoU losses with respect to the
logits, deltas and boxes within 1e-5 of the largest value; assignments,
sampled indices, is_pos, valid, labels and the mask targets equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.offline import detection_ops as jax_ops
from mde_tpu.offline import detection_train as jt
from mde_tpu_torch.offline import detection_ops
from mde_tpu_torch.offline import detection_train as pt

IMG_HW = (48, 64)
N_CLASSES = 10
R_SAMPLES = 32


def _inputs():
    rng = np.random.default_rng(0)
    h, w = IMG_HW
    xy = rng.uniform(0, [w - 12, h - 12], (6, 2))
    gt = np.concatenate([xy, xy + rng.uniform(6, 24, (6, 2))], 1).astype(np.float32)
    gt[3] = gt[2]                                  # two identical GTs
    gt_valid = np.array([True, True, True, True, False, False])
    gt_labels = rng.integers(0, N_CLASSES, 6).astype(np.int32)
    bxy = rng.uniform(-6, [w, h], (34, 2))
    boxes = np.concatenate([bxy, bxy + rng.uniform(2, 30, (34, 2))], 1).astype(np.float32)
    boxes = np.concatenate([boxes, gt[[0, 0, 1, 2, 4, 5]]]).astype(np.float32)  # ties
    masks = np.zeros((6, h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for g in range(6):
        x1, y1, x2, y2 = gt[g]
        masks[g] = ((xx + 0.5 - (x1 + x2) / 2) ** 2 / ((x2 - x1) / 2) ** 2
                    + (yy + 0.5 - (y1 + y2) / 2) ** 2 / ((y2 - y1) / 2) ** 2) <= 1
    anchors = jax_ops.grid_anchors(h // 8, w // 8, 8, scales=(2,))
    n_a = anchors.shape[0]
    return dict(
        gt=gt, gt_valid=gt_valid, gt_labels=gt_labels, boxes=boxes, masks=masks,
        anchors=anchors, rpn_cls=rng.standard_normal(n_a).astype(np.float32),
        rpn_deltas=(0.3 * rng.standard_normal((n_a, 4))).astype(np.float32),
        proposals=boxes[:30].copy(),
        cls_logits=rng.standard_normal((R_SAMPLES, N_CLASSES + 1)).astype(np.float32),
        deltas=(0.2 * rng.standard_normal((R_SAMPLES, 4))).astype(np.float32),
        mask_logits=rng.standard_normal((R_SAMPLES, 28, 28, N_CLASSES)).astype(np.float32),
        pred_boxes=(gt[[0, 1, 2, 3, 0, 1]] + rng.uniform(-3, 3, (6, 4))).astype(np.float32),
        key=jax.random.PRNGKey(7))


ASSIGN_CASES = {"rpn": (0.7, 0.3, 0.3, True), "rcnn": (0.5, 0.5, 0.5, False),
                "low_quality_only": (0.95, 0.2, 0.1, True)}
SAMPLE_CASES = {"rpn": ("rpn", 16, 0.5), "more_than_candidates": ("rcnn", 64, 0.25),
                "few_positives": ("low_quality_only", 24, 0.5)}


def _draws(key, n):
    r1, r2 = jax.random.split(key)
    return jax.random.uniform(r1, (n,)), jax.random.uniform(r2, (n,))


@pytest.fixture(scope="module")
def jax_side():
    d = _inputs()

    @jax.jit
    def run(d):
        out = {}
        for name, args in ASSIGN_CASES.items():
            out[f"assign_{name}"] = jt.max_iou_assign(d["boxes"], d["gt"], d["gt_labels"],
                                                      d["gt_valid"], *args)
        for name, (case, num, frac) in SAMPLE_CASES.items():
            k = jax.random.fold_in(d["key"], num)
            out[f"sample_{name}"] = jt.random_sample(k, out[f"assign_{case}"], num, frac)
            out[f"draws_{name}"] = _draws(k, d["boxes"].shape[0])
        k_rpn, k_stage = jax.random.split(d["key"])
        out["rpn_loss"] = jt.rpn_loss(d["anchors"], d["rpn_cls"], d["rpn_deltas"], d["gt"],
                                      d["gt_labels"], d["gt_valid"], k_rpn, IMG_HW, 64)
        out["draws_rpn_loss"] = _draws(k_rpn, d["anchors"].shape[0])
        tgt = jt.rcnn_stage_targets(k_stage, d["proposals"], d["gt"], d["gt_labels"],
                                    d["gt_valid"], 0.5, N_CLASSES, R_SAMPLES)
        out["draws_stage"] = _draws(k_stage, d["proposals"].shape[0] + 6)
        out["targets"] = tgt
        decoded = jax_ops.delta2bbox(tgt["rois"], d["deltas"], max_shape=IMG_HW)
        out["stage_loss"] = jt.rcnn_stage_loss(d["cls_logits"], decoded, tgt, N_CLASSES)
        out["mask_targets"] = jt.mask_targets(d["masks"], tgt)
        out["mask_loss"] = jt.mask_loss(d["mask_logits"], tgt, out["mask_targets"])
        labels = tgt["labels"]
        out["bbox2delta"] = jt.bbox2delta(d["boxes"][:6], d["gt"], stds=(0.1, 0.1, 0.2, 0.2))
        out["smooth_l1"] = jt.smooth_l1_loss(d["deltas"], 0.5 * d["deltas"][::-1], 1.0 / 9.0)
        out["giou"] = jt.giou(d["pred_boxes"], d["gt"])
        out["ce"] = jt.softmax_ce_loss(d["cls_logits"], labels)
        out["bce"] = jt.bce_with_logits(d["rpn_cls"], (d["rpn_cls"] > 0.3).astype(jnp.float32))
        out["grads"] = (
            jax.grad(lambda l: jt.softmax_ce_loss(l, labels).sum())(d["cls_logits"]),
            jax.grad(lambda l: jt.bce_with_logits(l, (d["rpn_cls"] > 0.3).astype(
                jnp.float32)).sum())(d["rpn_cls"]),
            jax.grad(lambda p: jt.smooth_l1_loss(p, 0.5 * d["deltas"][::-1], 1.0 / 9.0).sum())(
                d["deltas"]),
            jax.grad(lambda b: jt.giou_loss(b, d["gt"]).sum())(d["pred_boxes"]))
        return out

    out = run({k: v for k, v in d.items()})
    return d, jax.tree_util.tree_map(np.asarray, out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("case", list(ASSIGN_CASES))
def test_max_iou_assign_equals_jax(jax_side, case):
    d, out = jax_side
    got = pt.max_iou_assign(_t(d["boxes"]), _t(d["gt"]), _t(d["gt_labels"]).long(),
                            _t(d["gt_valid"]), *ASSIGN_CASES[case])
    want = out[f"assign_{case}"]
    _eq(got.gt_inds, want[0], "gt_inds")
    _eq(got.labels, want[2], "labels")
    np.testing.assert_allclose(got.max_ious.numpy(), want[1], rtol=1e-6, atol=1e-7)
    if case == "rpn":  # the ties are reached: boxes 34, 35 copy GT 0; GT 3 copies GT 2
        assert (want[0][34:36] == 0).all() and (want[0] == 3).sum() == 0
        assert (want[0] == -2).any() and (want[0] == -1).any()


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_random_sample_equals_jax(jax_side, case):
    d, out = jax_side
    assign_case, num, frac = SAMPLE_CASES[case]
    a = pt.max_iou_assign(_t(d["boxes"]), _t(d["gt"]), _t(d["gt_labels"]).long(),
                          _t(d["gt_valid"]), *ASSIGN_CASES[assign_case])
    draws = iter(_t(x) for x in out[f"draws_{case}"])
    idx, is_pos, valid = pt.random_sample(lambda n: next(draws), a, num, frac)
    want = out[f"sample_{case}"]
    for got, w, what in ((idx, want[0], "indices"), (is_pos, want[1], "is_pos"),
                         (valid, want[2], "valid")):
        _eq(got, w, what)
    if case == "more_than_candidates":  # invalid slots, filled by the tied -1 scores
        assert not want[2].all()


def test_rpn_loss_equals_jax(jax_side):
    d, out = jax_side
    draws = iter(_t(x) for x in out["draws_rpn_loss"])
    got = pt.rpn_loss(_t(d["anchors"]), _t(d["rpn_cls"]), _t(d["rpn_deltas"]), _t(d["gt"]),
                      _t(d["gt_labels"]).long(), _t(d["gt_valid"]), lambda n: next(draws),
                      IMG_HW, 64)
    np.testing.assert_allclose([float(v) for v in got], out["rpn_loss"], rtol=1e-6)
    assert out["rpn_loss"][1] > 0


def test_stage_targets_losses_and_mask_targets_equal_jax(jax_side):
    d, out = jax_side
    draws = iter(_t(x) for x in out["draws_stage"])
    tgt = pt.rcnn_stage_targets(lambda n: next(draws), _t(d["proposals"]), _t(d["gt"]),
                                _t(d["gt_labels"]).long(), _t(d["gt_valid"]), 0.5, N_CLASSES,
                                R_SAMPLES)
    want = out["targets"]
    assert set(tgt) == set(want)
    for k in want:
        if k in ("rois", "matched_gt"):
            np.testing.assert_array_equal(tgt[k].numpy(), want[k], err_msg=k)
        else:
            _eq(tgt[k], want[k], k)
    assert want["is_pos"].any() and not want["is_pos"].all()
    decoded = detection_ops.delta2bbox(tgt["rois"], _t(d["deltas"]), max_shape=IMG_HW)
    got = pt.rcnn_stage_loss(_t(d["cls_logits"]), decoded, tgt, N_CLASSES)
    np.testing.assert_allclose([float(v) for v in got], out["stage_loss"], rtol=1e-6)
    m = pt.mask_targets(_t(d["masks"]), tgt)
    _eq(m, out["mask_targets"], "mask targets")
    assert 0 < out["mask_targets"].mean() < 1
    ml = pt.mask_loss(_t(d["mask_logits"]).permute(0, 3, 1, 2), tgt, m)
    np.testing.assert_allclose(float(ml), out["mask_loss"], rtol=1e-6)


def test_coders_and_elementwise_losses_equal_jax(jax_side):
    d, out = jax_side
    labels = _t(out["targets"]["labels"]).long()
    target = (_t(d["rpn_cls"]) > 0.3).float()
    checks = {
        "bbox2delta": pt.bbox2delta(_t(d["boxes"][:6]), _t(d["gt"]), stds=(0.1, 0.1, 0.2, 0.2)),
        "smooth_l1": pt.smooth_l1_loss(_t(d["deltas"]), 0.5 * _t(d["deltas"][::-1]), 1.0 / 9.0),
        "giou": pt.giou(_t(d["pred_boxes"]), _t(d["gt"])),
        "ce": pt.softmax_ce_loss(_t(d["cls_logits"]), labels),
        "bce": pt.bce_with_logits(_t(d["rpn_cls"]), target)}
    for k, got in checks.items():
        np.testing.assert_allclose(got.numpy(), out[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_loss_gradients_equal_jax(jax_side):
    d, out = jax_side
    labels = _t(out["targets"]["labels"]).long()
    target = (_t(d["rpn_cls"]) > 0.3).float()
    fns = (lambda l: pt.softmax_ce_loss(l, labels).sum(),
           lambda l: pt.bce_with_logits(l, target).sum(),
           lambda p: pt.smooth_l1_loss(p, 0.5 * _t(d["deltas"][::-1]), 1.0 / 9.0).sum(),
           lambda b: pt.giou_loss(b, _t(d["gt"])).sum())
    for fn, x, want in zip(fns, ("cls_logits", "rpn_cls", "deltas", "pred_boxes"), out["grads"]):
        t = _t(d[x]).requires_grad_(True)
        fn(t).backward()
        err = np.abs(t.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (x, err)


def test_training_after_inference_in_one_process():
    """A detector that has detected under torch.inference_mode trains next:
    its cached position index and anchors are normal tensors (a training
    step saves them for its backward)."""
    from mde_tpu_torch.offline.cascade_rcnn import CascadeMaskRCNN
    from mde_tpu_torch.offline.layers import seeded
    model = seeded(lambda: CascadeMaskRCNN(N_CLASSES, depths=(2, 2, 2, 2)), 0)
    image = torch.randn((1, 3, *IMG_HW), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model.infer(image, IMG_HW)
    d = _inputs()
    gen = torch.Generator().manual_seed(1)
    losses = model.train().compute_losses(
        image, _t(d["gt"]), _t(d["gt_labels"]).long(), _t(d["gt_valid"]), _t(d["masks"]),
        pt.generator_uniform(gen), IMG_HW, num_samples=16)
    losses["total"].backward()
    assert model.backbone.layers[0].blocks[0].attn.relative_position_bias_table.grad is not None
