"""Port parity, the offline instance generator: mde_tpu_torch.offline's
Cascade Mask R-CNN (Swin-B, FPN, RPN, the cascade, the masks) against
mde_tpu.offline (CPU, float32), through `CascadeMaskRCNN.infer` at 64x96.

The port keeps mmdet's state_dict names, so the JAX model is seeded
through its own converter (`convert_detector`) from the port's state_dict
(no JAX init), and the keys it reads are recorded: a port key it never
reads fails. Two of `convert_detector`'s mappings differ from mmdet, whose
layout the port computes: it feeds `shared_fcs.0` the roi features
flattened (H, W, C) where mmdet flattens (C, H, W), and it gives flax's
ConvTranspose the mask upsample kernel unflipped, where torch's
ConvTranspose2d is the flipped correlation. The file handed to
`convert_detector` carries those two tensors reordered, so both sides
compute one function (ROADMAP §3; pinned in
tests/test_torch_port_offline_swin.py).

Tolerances (float32), on the valid detections: the same valid slots,
labels equal, scores 2e-5 absolute (class probabilities averaged over
three stages, after ~30 float32 blocks; the classifier's weights are
scaled by 8, and its errors with them: 7e-6 measured), boxes 1e-3 px,
masks 1e-5. The classifier is seeded so that the valid scores lie far
apart against float32 noise, with the score threshold raised as the
scripts' --score-thr sets it: at 0.18, 17 valid detections, the smallest
gap 1.6e-4 (the test asserts 1e-4); the JAX side runs under jax.jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.offline import cascade_rcnn as jax_rcnn
from mde_tpu.offline.swin_convert import convert_detector
from mde_tpu_torch.offline import cascade_rcnn
from mde_tpu_torch.offline.layers import seeded

torch.set_num_threads(2)

HW = (64, 96)
SCORE_THR = 0.18  # 17 valid detections on this input and seed


class _Recording(dict):
    def __init__(self, *a, read):
        super().__init__(*a)
        self.read = read

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


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


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """(port model, JAX variables, keys read, port keys)."""
    model = seeded(lambda: cascade_rcnn.CascadeMaskRCNN(score_thr=SCORE_THR), 0).eval()
    with torch.no_grad():  # a sharper classifier: valid scores far apart
        for head in model.roi_head.bbox_head:
            head.fc_cls.weight.mul_(8.0)
    # the file is ~580 MB: removed as soon as the converter has read it
    jax_file = tmp_path_factory.mktemp("detector") / "cascade_jax_layout.pth"
    torch.save({"state_dict": _to_jax_layout(model.state_dict())}, jax_file)
    read = set()
    real_load = torch.load

    def load(path, *a, **k):
        ckpt = real_load(path, *a, **k)
        return {"state_dict": _Recording(ckpt["state_dict"], read=read)}

    torch.load = load
    try:
        params, stats = convert_detector(str(jax_file))
    finally:
        torch.load = real_load
        jax_file.unlink()
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    return model, variables, read, set(model.state_dict())


def test_converter_reads_every_port_key(detector):
    _, _, read, own = detector
    assert own - read == set(), "keys convert_detector never reads"
    assert read <= own


def test_infer_matches_jax_on_the_valid_detections(detector):
    model, variables, *_ = detector
    x = np.random.default_rng(0).standard_normal((1, *HW, 3), dtype=np.float32)
    jmodel = jax_rcnn.CascadeMaskRCNN(num_classes=100, dtype=jnp.float32, score_thr=SCORE_THR)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, HW, method=jax_rcnn.CascadeMaskRCNN.infer))(
        variables, x)
    want = {k: np.asarray(v) for k, v in want.items()}
    with torch.no_grad():
        got = model.infer(torch.from_numpy(x).permute(0, 3, 1, 2), HW)
    got = {k: v.numpy() for k, v in got.items()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    n = int(v.sum())
    scores = np.sort(want["scores"][v])
    assert n >= 10, f"only {n} valid detections: the test shows little"
    assert np.diff(scores).min() > 1e-4, "valid scores closer than the test can order"
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks28"][v], want["masks28"][v], rtol=0, atol=1e-5)
