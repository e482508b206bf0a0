"""Evaluate the Swin-B Cascade Mask R-CNN on a COCO-format set, the port of
`scripts/eval_detector.py` (the Swin fork's tools/test.py --eval bbox segm):

    python -m mde_tpu_torch.offline.eval_detector --images val/images \\
        --annotations inst_val.json --checkpoint epoch_36.pth [--num-classes 100] \\
        [--max-images N] [--score-thr 0.05] [--max-long L --max-short S]

Every annotated image through `generate_instances.preprocess` (keep-ratio to
(1333, 800) unless --max-long / --max-short), the detector in bfloat16,
boxes scaled back to the frame, `paste_masks`, and the port's
`DetectionEvaluator`; prints bbox and segm mAP@[.5:.95] and mAP50 as the
script does. The checkpoint is an mmdet .pth (a published file or one that
`train_detector` wrote), read by `load_detector`. --score-thr also sets the
model's own class-score cut (the JAX script keeps the model's 0.05 and
filters after it: the same detections at the default). The run is on the
card unless --device cpu; a missing card is an error.
"""

import argparse

import numpy as np

from .cascade_rcnn import load_detector, paste_masks
from .coco_dataset import CocoInstanceDataset
from .detection_eval import DetectionEvaluator
from .generate_instances import COMPUTE_DTYPE, MAX_LONG, MAX_SHORT, detect
from .generate_semantics import device_of


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True)
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--num-classes", type=int, default=100)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--score-thr", type=float, default=0.05)
    ap.add_argument("--max-long", type=int, default=None,
                    help="override the 1333 keep-ratio long side")
    ap.add_argument("--max-short", type=int, default=None,
                    help="override the 800 keep-ratio short side")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_detector(args, device):
    return load_detector(args.checkpoint, dtype=COMPUTE_DTYPE, num_classes=args.num_classes,
                         score_thr=args.score_thr).to(device).eval()


def main(argv=None) -> dict:
    args = parse_args(argv)
    model = build_detector(args, device_of(args.device))
    max_long, max_short = args.max_long or MAX_LONG, args.max_short or MAX_SHORT
    ds = CocoInstanceDataset(args.images, args.annotations)
    n = len(ds) if args.max_images is None else min(len(ds), args.max_images)
    print(f"evaluating {n} images")
    ev = DetectionEvaluator(args.num_classes, with_masks=True)
    for i in range(n):
        img, gt_boxes, gt_labels, gt_masks = ds[i]
        h, w = img.shape[:2]
        det = detect(model, img, max_long, max_short)
        keep = det["valid"] & (det["scores"] > args.score_thr)
        masks_full = paste_masks(det, h, w)
        ev.add_image({"boxes": det["boxes"][keep], "scores": det["scores"][keep],
                      "labels": det["labels"][keep], "masks": masks_full[keep]},
                     {"boxes": gt_boxes, "labels": gt_labels, "masks": gt_masks})
        if i % 25 == 0:
            print(f"{i}/{n}")
    summary = ev.summarize()
    for k, v in summary.items():
        print(f"{k}: {v:.4f}")
    return summary


if __name__ == "__main__":
    main()
