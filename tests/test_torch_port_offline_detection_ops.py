"""Port parity, detection primitives: mde_tpu_torch.offline.detection_ops
against mde_tpu.offline.detection_ops (CPU, float32).

Anchors are numpy on both sides and equal. delta2bbox, box_iou and the
FPN level map are elementwise float32 on both sides: rtol 1e-6. NMS is
compared index for index and validity for validity: on tie-free scores,
with one explicit tie (the lower index first on both sides) and with an
all-invalid tail (more slots than survivors: index 0, valid False). RoIAlign
keeps the JAX package's static 2 x 2 lattice: rtol 1e-5 / atol 1e-5 (the
four taps a sample are summed in one order on both sides, the four samples
a bin in another). The JAX side runs under jax.jit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.offline import detection_ops as J
from mde_tpu_torch.offline import detection_ops as P

torch.set_num_threads(2)


def _boxes(rng, n, lo=0.0, hi=120.0, min_size=2.0, max_size=60.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(min_size, max_size, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.mark.parametrize("stride,shape", [(4, (5, 7)), (64, (2, 3))])
def test_anchors_equal_jax(stride, shape):
    np.testing.assert_array_equal(P.base_anchors(stride), J.base_anchors(stride))
    np.testing.assert_array_equal(P.grid_anchors(*shape, stride), J.grid_anchors(*shape, stride))


def test_delta2bbox_box_iou_and_levels_match_jax():
    rng = np.random.default_rng(0)
    rois = _boxes(rng, 300, min_size=0.5, max_size=400)
    deltas = rng.normal(0, 2.0, (300, 4)).astype(np.float32)  # some beyond the clip
    for kw in ({}, {"stds": (0.1, 0.1, 0.2, 0.2), "max_shape": (100, 150)},
               {"means": (0.1, -0.2, 0.0, 0.3), "stds": (0.033, 0.033, 0.067, 0.067)}):
        want = np.asarray(jax.jit(functools.partial(J.delta2bbox, **kw))(rois, deltas))
        got = P.delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    b2 = _boxes(rng, 50)
    b2[0] = [5, 5, 5, 9]  # zero width
    want = np.asarray(jax.jit(J.box_iou)(rois[:80], b2))
    got = P.box_iou(torch.from_numpy(rois[:80]), torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    levels = np.concatenate([rois, [[0, 0, 56, 56], [0, 0, 112, 112], [0, 0, 0, 0]]]).astype(np.float32)
    np.testing.assert_array_equal(
        P.map_rois_to_fpn_levels(torch.from_numpy(levels)).numpy(),
        np.asarray(jax.jit(J.map_rois_to_fpn_levels)(levels)))


def _nms_case(kind):
    rng = np.random.default_rng({"tie-free": 1, "tie": 2, "all-invalid tail": 3}[kind])
    if kind == "all-invalid tail":  # 40 boxes in 4 clusters: few survive 60 slots
        centers = rng.uniform(20, 100, (4, 2))
        xy = np.repeat(centers, 10, axis=0) + rng.normal(0, 1.0, (40, 2))
        boxes = np.concatenate([xy, xy + 30 + rng.normal(0, 1.0, (40, 2))], 1).astype(np.float32)
        scores = rng.permutation(40).astype(np.float32) / 40
        return boxes, scores, 60
    boxes = _boxes(rng, 200)
    scores = rng.permutation(200).astype(np.float32) / 200 + 0.01
    if kind == "tie":  # two overlapping boxes with one score: the lower index wins
        boxes[17] = boxes[5] + np.float32(1.0)
        scores[5] = scores[17] = 2.0
    return boxes, scores, 100


@pytest.mark.parametrize("kind", ["tie-free", "tie", "all-invalid tail"])
def test_nms_fixed_matches_jax(kind):
    boxes, scores, max_out = _nms_case(kind)
    want_idx, want_valid = jax.jit(functools.partial(J.nms_fixed, iou_threshold=0.5,
                                                     max_out=max_out))(boxes, scores)
    got_idx, got_valid = P.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                                     max_out)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    n_valid = int(np.asarray(want_valid).sum())
    if kind == "all-invalid tail":
        assert n_valid < max_out and (got_idx.numpy()[n_valid:] == 0).all()
    if kind == "tie":
        kept = list(got_idx.numpy()[:n_valid])
        assert kept[0] == 5 and 17 not in kept


def test_batched_nms_matches_jax_and_separates_ids():
    rng = np.random.default_rng(4)
    boxes = _boxes(rng, 150)
    boxes[75:] = boxes[:75]  # the same boxes again under other ids
    scores = rng.permutation(150).astype(np.float32) / 150
    ids = np.repeat(np.arange(2, dtype=np.int32), 75)
    want_idx, want_valid = jax.jit(functools.partial(J.batched_nms_fixed, iou_threshold=0.5,
                                                     max_out=120))(boxes, scores, ids)
    got_idx, got_valid = P.batched_nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                                             torch.from_numpy(ids), 0.5, 120)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


def test_top_k_orders_ties_as_jax():
    s = np.asarray([0.5, 0.9, 0.5, 0.0, 0.9, 0.0, 0.0, 0.7], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), 6)
    got_v, got_i = P.top_k(torch.from_numpy(s), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _rois_for_levels(rng, n, hw):
    """Rois over the image, some past its edges and some degenerate, sizes
    spread over the four FPN levels."""
    h, w = hw
    size = np.exp(rng.uniform(np.log(2), np.log(1000), (n, 2)))
    xy = rng.uniform(-20, [w, h], (n, 2))
    rois = np.concatenate([xy, xy + size], axis=1)
    rois[:3] = [[10, 10, 10, 30], [5, 5, 5.2, 5.2], [w - 3, h - 3, w + 40, h + 40]]
    rois[3:7] = [[x, x, x + side, x + side] for x, side in ((3, 40), (-7, 150), (-50, 300),
                                                            (-200, 600))]  # levels 0-3
    return rois.astype(np.float32)


def test_roi_align_and_extract_roi_features_match_jax():
    rng = np.random.default_rng(5)
    hw = (64, 96)
    feats = [rng.standard_normal((1, hw[0] // s, hw[1] // s, 16), dtype=np.float32)
             for s in (4, 8, 16, 32)]
    rois = _rois_for_levels(rng, 64, hw)
    tfeats = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous() for f in feats]
    for size, scale, ratio in ((7, 0.25, 0), (14, 0.125, 0), (7, 0.25, 3)):
        level = {0.25: 0, 0.125: 1}[scale]
        want = np.asarray(jax.jit(functools.partial(
            J.roi_align, output_size=size, spatial_scale=scale, sampling_ratio=ratio))(
                feats[level], rois))
        got = P.roi_align(tfeats[level], torch.from_numpy(rois), size, scale, ratio).numpy()
        np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-5, atol=1e-5)
    lv = P.map_rois_to_fpn_levels(torch.from_numpy(rois)).numpy()
    assert set(lv) == {0, 1, 2, 3}, lv
    for size in (7, 14):
        want = np.asarray(jax.jit(functools.partial(J.extract_roi_features, output_size=size))(
            feats, rois))
        got = P.extract_roi_features(tfeats, torch.from_numpy(rois), size).numpy()
        np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-5, atol=1e-5)
    bf16 = P.extract_roi_features([t.to(torch.bfloat16) for t in tfeats], torch.from_numpy(rois), 7)
    assert bf16.dtype == torch.float32  # bf16 maps sampled in float32, as JAX promotes
