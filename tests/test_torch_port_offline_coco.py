"""Port parity, the detector's data: mde_tpu_torch.offline's COCO loader and
AutoAugment against mde_tpu.offline's, which run on Pillow (CPU, numpy).

* The polygon fill (`data/decode.py::fill_polygon`, the host library's copy
  of PIL's scanline fill) against `ImageDraw.polygon(xy, outline=1, fill=1)`
  on an "L" image, pixel for pixel, on 240 random polygons with float
  vertices: convex, star-shaped (concave), random (self-crossing) and partly
  outside the image.
* The NEAREST resize (`data/transforms.py::resize_nearest_pil`) against
  Pillow's at every size AutoAugment gives a 480x640 frame and at random
  sizes.
* On a written COCO tree (RGB JPEG, RGB PNG, a grayscale JPEG and an RGBA
  PNG; polygons of several parts with float vertices, uncompressed RLE,
  bbox-only, crowd, boxes of 1 px or less, a category outside the list):
  every item (image, boxes, labels, masks) and `train_sample` under the same
  numpy seeds, with the full scale sets and with one fixed scale, equal bit
  for bit (the JAX masks are float32 of the same {0, 1}).
* Compressed RLE raises on both sides.
"""

import json

import numpy as np
import pytest
from PIL import Image, ImageDraw

from mde_tpu.offline import coco_dataset as jax_coco
from mde_tpu.offline import detection_data as jax_data
from mde_tpu_torch.data.decode import fill_polygon
from mde_tpu_torch.data.transforms import resize_nearest_pil
from mde_tpu_torch.offline import coco_dataset, detection_data

MAX_GT = 8


def _pil_polygon(h, w, xy):
    img = Image.new("L", (w, h), 0)
    pts = [(xy[i], xy[i + 1]) for i in range(0, len(xy) - 1, 2)]
    ImageDraw.Draw(img).polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def _random_polygon(rng, kind, h, w):
    n = int(rng.integers(3, 16))
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    if kind == "convex":
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(1, max(h, w))
        xy = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
    elif kind == "concave":
        cx, cy = rng.uniform(0.3 * w, 0.7 * w), rng.uniform(0.3 * h, 0.7 * h)
        r = rng.uniform(1, 0.5 * min(h, w), n)
        xy = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
    elif kind == "self_crossing":
        xy = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], 1)
    else:  # partly outside
        xy = np.stack([rng.uniform(-0.3 * w, 1.3 * w, n), rng.uniform(-0.3 * h, 1.3 * h, n)], 1)
    return xy.reshape(-1).tolist()


@pytest.mark.parametrize("kind", ["convex", "concave", "self_crossing", "partly_outside"])
def test_polygon_fill_equals_pillow(kind):
    rng = np.random.default_rng(["convex", "concave", "self_crossing",
                                 "partly_outside"].index(kind))
    for t in range(60):
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        xy = _random_polygon(rng, kind, h, w)
        got = np.zeros((h, w), np.uint8)
        fill_polygon(got, xy)
        np.testing.assert_array_equal(got, _pil_polygon(h, w, xy), err_msg=f"{kind} {t}: {xy}")


def test_nearest_resize_equals_pillow():
    rng = np.random.default_rng(0)
    sizes = set()
    for short, lmax in detection_data.SCALES_MAIN + detection_data.SCALES_PRE_CROP:
        scale = min(short / 480, lmax / 640)
        sizes.add(((480, 640), (int(640 * scale + 0.5), int(480 * scale + 0.5))))
    for _ in range(40):
        sizes.add((tuple(int(v) for v in rng.integers(1, 300, 2)),
                   tuple(int(v) for v in rng.integers(1, 900, 2))))
    for (h, w), (tw, th) in sorted(sizes):
        m = rng.integers(0, 2, (h, w), dtype=np.uint8)
        want = np.asarray(Image.fromarray(m).resize((tw, th), Image.NEAREST))
        np.testing.assert_array_equal(resize_nearest_pil(m, (tw, th)), want,
                                      err_msg=f"{(h, w)} -> {(th, tw)}")


def _rle(mask):
    """Uncompressed COCO RLE (column-major runs, starting with zeros)."""
    flat = mask.T.reshape(-1)
    counts, val, run = [], 0, 0
    for v in flat:
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    counts.append(run)
    return {"size": list(mask.shape), "counts": [int(c) for c in counts]}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(0)
    h, w = 60, 80
    images, anns = [], []
    files = [("a.jpg", "RGB"), ("b.png", "RGB"), ("c.jpg", "L"), ("d.png", "RGBA")]
    aid = 0
    for i, (name, mode) in enumerate(files):
        channels = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        pix = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        Image.fromarray(pix[..., 0] if channels == 1 else pix, mode).save(root / name)
        images.append({"id": 10 + i, "file_name": name, "height": h, "width": w})
        blob = np.zeros((h, w), np.uint8)
        blob[10:30, 20:50] = 1
        blob[25:40, 5:25] = 1
        segs = [
            [[10.3, 5.7, 40.2, 8.1, 35.5, 30.9, 12.8, 25.4],
             [50.5, 40.5, 70.2, 42.7, 60.1, 55.5]],                # two parts, float
            _rle(blob),                                             # uncompressed RLE
            None,                                                   # bbox-only
            [[1.0, 1.0, 78.6, 3.2, 40.4, 58.9, 5.5, 30.0, 60.0, 20.0]],  # self-crossing
        ]
        bboxes = [[10.3, 5.7, 30.0, 25.2], [5.0, 10.0, 45.0, 30.0], [15.5, 12.25, 20.5, 30.75],
                  [1.0, 1.0, 77.6, 57.9]]
        for j, (seg, box) in enumerate(zip(segs, bboxes)):
            ann = {"id": aid, "image_id": 10 + i, "category_id": [3, 7, 11, 7][j], "bbox": box,
                   "iscrowd": 0}
            if seg is not None:
                ann["segmentation"] = seg
            anns.append(ann)
            aid += 1
        anns.append({"id": aid, "image_id": 10 + i, "category_id": 3, "bbox": [0, 0, 9, 9],
                     "iscrowd": 1, "segmentation": [[0, 0, 9, 0, 9, 9]]})           # crowd
        anns.append({"id": aid + 1, "image_id": 10 + i, "category_id": 7,
                     "bbox": [3, 3, 1.0, 6.0], "iscrowd": 0})                        # 1 px wide
        anns.append({"id": aid + 2, "image_id": 10 + i, "category_id": 99,
                     "bbox": [3, 3, 20.0, 20.0], "iscrowd": 0})                      # no class
        aid += 3
    images.append({"id": 99, "file_name": "unannotated.jpg", "height": h, "width": w})
    ann_file = root / "instances.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": c, "name": str(c)} for c in (3, 7, 11)]}))
    return root, ann_file


def _datasets(tree):
    root, ann_file = tree
    return (coco_dataset.CocoInstanceDataset(str(root), str(ann_file)),
            jax_coco.CocoInstanceDataset(str(root), str(ann_file)))


def test_items_equal_jax(tree):
    ds, jds = _datasets(tree)
    assert len(ds) == len(jds) == 4 and ds.ids == jds.ids
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        for g, w_, what in zip(got, want, ("image", "boxes", "labels", "masks")):
            assert g.dtype == w_.dtype and g.shape == w_.shape, what
            np.testing.assert_array_equal(g, w_, err_msg=f"item {i} {what}")
        assert got[3].sum(axis=(1, 2)).min() > 0


@pytest.mark.parametrize("scales", ["full", "fixed"])
def test_train_samples_equal_jax(tree, scales, monkeypatch):
    ds, jds = _datasets(tree)
    aug = detection_data.AugScales()
    if scales == "fixed":  # the JAX CLI's --fixed-scale 256,352 sets its module globals
        aug = detection_data.fixed_scales(256, 352)
        monkeypatch.setattr(jax_data, "SCALES_MAIN", [(256, 352)])
        monkeypatch.setattr(jax_data, "SCALES_PRE_CROP", [(256, 352)])
        monkeypatch.setattr(jax_data, "CROP_RANGE", (256, 256))
    seen_hw = set()
    for seed in range(3 if scales == "full" else 2):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for i in range(len(ds)):
            got = ds.train_sample(rng, i, max_gt=MAX_GT, scales=aug)
            want = jds.train_sample(jrng, i, max_gt=MAX_GT)
            assert set(got) == set(want)
            for k in want:
                if k == "gt_masks":
                    assert got[k].dtype == np.uint8 and want[k].dtype == np.float32
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                              err_msg=f"seed {seed} item {i} {k}")
            seen_hw.add(tuple(got["valid_hw"]))
    assert len(seen_hw) > 1 or scales == "fixed"


def test_compressed_rle_raises():
    seg = {"size": [4, 4], "counts": "abc"}
    with pytest.raises(ValueError, match="compressed RLE"):
        coco_dataset._decode_segmentation(seg, 4, 4)
    with pytest.raises(ValueError, match="compressed RLE"):
        jax_coco._decode_segmentation(seg, 4, 4)
