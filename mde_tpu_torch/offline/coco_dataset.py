"""COCO-format instance dataset for detector training, the port of
`mde_tpu/offline/coco_dataset.py` (:1-98): the capability of mmdet's
CocoDataset with the ade20k instance config.

The json is parsed with the standard library; polygon segmentations are
filled by the port's host library exactly as PIL's `ImageDraw.polygon(xy,
outline=1, fill=1)` fills them (`data/decode.py::fill_polygon`),
uncompressed RLE is decoded in numpy, and compressed RLE raises (no
pycocotools), as in the JAX module. Images are read by `read_rgb`, which
turns grey and alpha files into RGB as PIL's `convert("RGB")`. Samples go
through `detection_data.autoaugment_sample` and `pad_gt`.
"""

import json
import os

import numpy as np

from ..data.decode import fill_polygon, read_rgb
from .detection_data import AugScales, autoaugment_sample, pad_gt


def _decode_segmentation(seg, h, w):
    """Polygon list or uncompressed RLE dict -> (h, w) uint8 mask."""
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, list):  # uncompressed RLE, column-major
            flat = np.zeros(h * w, np.uint8)
            pos = 0
            val = 0
            for run in counts:
                if val:
                    flat[pos:pos + run] = 1
                pos += run
                val ^= 1
            return flat.reshape(w, h).T
        raise ValueError("compressed RLE requires pycocotools; re-export "
                         "annotations with polygons or uncompressed RLE")
    mask = np.zeros((h, w), np.uint8)
    for poly in seg:
        n = len(poly) // 2
        if n >= 3:
            fill_polygon(mask, poly[:2 * n])
    return mask


class CocoInstanceDataset:
    """Indexable (image, boxes, labels, masks) dataset from a COCO json."""

    def __init__(self, images_dir: str, annotations_json: str, class_ids=None):
        self.images_dir = images_dir
        with open(annotations_json) as f:
            coco = json.load(f)
        cats = sorted(c["id"] for c in coco.get("categories", []))
        if class_ids is not None:
            cats = list(class_ids)
        self.cat_to_label = {cid: i for i, cid in enumerate(cats)}
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_image = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids = [i for i in self.images if self.anns_by_image.get(i)]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int):
        img_id = self.ids[idx]
        info = self.images[img_id]
        img = read_rgb(os.path.join(self.images_dir, info["file_name"]))
        h, w = img.shape[:2]
        boxes, labels, masks = [], [], []
        for ann in self.anns_by_image[img_id]:
            x, y, bw, bh = ann["bbox"]
            if bw <= 1 or bh <= 1 or ann["category_id"] not in self.cat_to_label:
                continue
            boxes.append([x, y, x + bw, y + bh])
            labels.append(self.cat_to_label[ann["category_id"]])
            if "segmentation" in ann and ann["segmentation"]:
                masks.append(_decode_segmentation(ann["segmentation"], h, w))
            else:
                m = np.zeros((h, w), np.uint8)
                m[int(y):int(y + bh), int(x):int(x + bw)] = 1
                masks.append(m)
        return (img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32),
                np.stack(masks) if masks else np.zeros((0, h, w), np.uint8))

    def train_sample(self, rng: np.random.Generator, idx: int, max_gt: int = 100,
                     scales: AugScales = AugScales()):
        """Augmented and statically padded training sample."""
        img, boxes, labels, masks = self[idx]
        pad, b, l, m, valid_hw = autoaugment_sample(rng, img, boxes, labels, masks, scales)
        gb, gl, gv, gm = pad_gt(b, l, m, pad.shape[:2], max_gt=max_gt)
        return dict(image=pad, gt_boxes=gb, gt_labels=gl, gt_valid=gv, gt_masks=gm,
                    valid_hw=valid_hw)
