"""Instance cue maps over an NYUD2 tree, the port of
`scripts/generate_instances.py` (the reference's
Swin-Transformer-Object-Detection/tools/nyud2_inference.py:62-139):

    python -m mde_tpu_torch.offline.generate_instances --images data/nyu/sync \\
        --checkpoint cascade_mask_rcnn_swin_base_ade20k.pth [--bbox-areas]
    python -m mde_tpu_torch.offline.generate_instances --images DIR --random-init 0 \\
        --score-thr 0.011 [--depths DIR --stats-out stats.pkl]

For every rgb_*.jpg under --images: Swin-B Cascade Mask R-CNN in bfloat16
(the test pipeline of configs/_base_/datasets/ade20k_instance.py:
keep-ratio resize to (1333, 800) by the port's PIL-exact resize, mmdet's
normalisation, padding to /32), the boxes scaled back to the frame, the
masks pasted, and the detections collapsed into one label map and one area
map (mask pixels, or box area with --bbox-areas):
- --classes ade20k (default): instance_{labels,areas}_ade20k_swin[_bbox]_*.npz
  beside the frame (compressed; labels 0..99, background -1); an npz
  holding the object None when nothing is valid, as the reference;
- --classes coco: instance_{labels,areas}_coco_*.npy (the matterport
  convention: background 0, classes 1..80; the reference's coco script
  painted roi indices, this paints class ids).
An existing pair is kept unless --overwrite. With --depths, the per-class
(area, depth mean, depth std) of each valid detection is collected from
sync_depth_*.png (the port's PNG decoder) and, with --stats-out, pickled
(a list of num_classes + 1 lists). The run is on the card unless --device
cpu; a missing card, or a checkpoint that does not load, is an error.
"""

import argparse
import glob
import os
import pickle

import numpy as np
import torch

from ..data.decode import read_png, read_rgb
from ..data.transforms import resize_bilinear_pil
from .cascade_rcnn import CascadeMaskRCNN, collapse_detections, load_detector, paste_masks
from .generate_semantics import device_of
from .layers import seeded, to_compute_dtype

COMPUTE_DTYPE = torch.bfloat16
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)
MAX_LONG, MAX_SHORT = 1333, 800


def preprocess(img_u8: np.ndarray, max_long: int = MAX_LONG, max_short: int = MAX_SHORT):
    """Keep-ratio resize + normalise + pad to /32. Returns (padded (ph, pw, 3)
    float32, (sx, sy), resized (th, tw))."""
    h, w = img_u8.shape[:2]
    scale = min(max_long / max(h, w), max_short / min(h, w))
    th, tw = int(h * scale + 0.5), int(w * scale + 0.5)
    x = (resize_bilinear_pil(img_u8, (tw, th)).astype(np.float32) - MEAN) / STD
    out = np.zeros((((th + 31) // 32) * 32, ((tw + 31) // 32) * 32, 3), np.float32)
    out[:th, :tw] = x
    return out, (tw / w, th / h), (th, tw)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--random-init", type=int, default=None, metavar="SEED",
                    help="no checkpoint: weights drawn from SEED as flax initialises "
                         "them (system runs of the offline -> side-file -> cue-training loop)")
    ap.add_argument("--bbox-areas", action="store_true",
                    help="use bbox area instead of mask area (the _bbox variant)")
    ap.add_argument("--classes", choices=["ade20k", "coco"], default="ade20k")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="detector head classes (default 100 ade20k / 80 coco)")
    ap.add_argument("--depths", default=None,
                    help="collect the area/depth stats from the sync_depth pngs")
    ap.add_argument("--stats-out", default=None)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--score-thr", type=float, default=0.05,
                    help="test_cfg.rcnn score threshold (lower for random-init runs: "
                         "an untrained softmax sits near 1/(C+1))")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.random_init is None and not args.checkpoint:
        ap.error("--checkpoint required unless --random-init")
    args.num_classes = args.num_classes or (80 if args.classes == "coco" else 100)
    return args


def build_detector(args, device) -> CascadeMaskRCNN:
    if args.random_init is not None:
        model = to_compute_dtype(seeded(lambda: CascadeMaskRCNN(
            args.num_classes, args.score_thr), args.random_init), COMPUTE_DTYPE)
    else:
        model = load_detector(args.checkpoint, dtype=COMPUTE_DTYPE,
                              num_classes=args.num_classes, score_thr=args.score_thr)
    return model.to(device).eval()


def detect(model: CascadeMaskRCNN, img_u8: np.ndarray, max_long: int = MAX_LONG,
           max_short: int = MAX_SHORT) -> dict:
    """One frame's detections as numpy arrays, boxes in the frame's pixels."""
    device = next(model.parameters()).device
    x, (sx, sy), (th, tw) = preprocess(img_u8, max_long, max_short)
    with torch.inference_mode():
        det = model.infer(torch.from_numpy(x).permute(2, 0, 1)[None].to(device), (th, tw))
        det = {k: v.cpu().numpy() for k, v in det.items()}
    det["boxes"] = det["boxes"] / np.array([sx, sy, sx, sy], np.float32)
    return det


def cue_maps(det: dict, h: int, w: int, coco: bool, bbox_areas: bool):
    """(masks (D, h, w) bool, labels map, areas map) in the output convention."""
    masks = paste_masks(det, h, w)
    if coco:  # background 0, classes shifted to 1..num_classes
        labels_map, areas_map = collapse_detections(dict(det, labels=det["labels"] + 1), masks,
                                                    h, w, use_bbox_area=bbox_areas)
        return masks, np.where(labels_map < 0, 0, labels_map), areas_map
    return (masks, *collapse_detections(det, masks, h, w, use_bbox_area=bbox_areas))


def main(argv=None):
    args = parse_args(argv)
    model = build_detector(args, device_of(args.device))
    coco = args.classes == "coco"
    if coco:
        tag, ext = "coco", ".npy"
    else:
        tag, ext = ("ade20k_swin_bbox" if args.bbox_areas else "ade20k_swin"), ".npz"
    files = sorted(glob.glob(os.path.join(args.images, "**", "rgb_*.jpg"), recursive=True))
    print(f"{len(files)} images")
    area_depth_std_points = [[] for _ in range(args.num_classes + 1)]
    for n, f in enumerate(files):
        lab_path = f.replace("rgb", "instance_labels_" + tag).replace(".jpg", ext)
        area_path = f.replace("rgb", "instance_areas_" + tag).replace(".jpg", ext)
        if os.path.exists(lab_path) and os.path.exists(area_path) and not args.overwrite:
            continue
        img = read_rgb(f)
        h, w = img.shape[:2]
        det = detect(model, img)
        masks, labels_map, areas_map = cue_maps(det, h, w, coco, args.bbox_areas)
        if coco:
            np.save(lab_path, labels_map)
            np.save(area_path, areas_map)
        elif not det["valid"].any():  # the reference writes object-None npz files
            np.savez_compressed(lab_path, np.array(None, dtype=object))
            np.savez_compressed(area_path, np.array(None, dtype=object))
        else:
            np.savez_compressed(lab_path, labels_map)
            np.savez_compressed(area_path, areas_map)
        if args.depths:
            dpath = f.replace("rgb", "sync_depth").replace(".jpg", ".png")
            if os.path.exists(dpath):
                depth = read_png(dpath).astype(np.float32) / 1000.0
                for i in np.flatnonzero(det["valid"]):
                    m = masks[i]
                    if m.any():
                        area_depth_std_points[int(det["labels"][i])].append(
                            [int(m.sum()), float(depth[m].mean()), float(depth[m].std())])
        if n % 25 == 0:
            print(f"{n}/{len(files)}")
    if args.stats_out:
        with open(args.stats_out, "wb") as fh:
            pickle.dump(area_depth_std_points, fh)
        print(f"wrote stats -> {args.stats_out}")


if __name__ == "__main__":
    main()
