"""Semantic-segmentation evaluation, the port of `scripts/eval_semseg.py`
(the reference's semantic-segmentation-pytorch/eval_multipro.py, one
process): mIoU and pixel accuracy over an ADE20K-style list.

    python -m mde_tpu_torch.offline.eval_semseg --odgt validation.odgt \\
        --root ADEChallengeData2016 --encoder-ckpt encoder_epoch_30.pth \\
        --decoder-ckpt decoder_epoch_30.pth [--max-images N] [--result-dir DIR]

The list is odgt (json lines {"fpath_img", "fpath_segm"}); annotation PNGs
hold class ids 1..150 with 0 unlabelled (-1, ignored: mit_semseg's segm - 1).
Each frame goes through HRNetV2-W48 + C1 in bfloat16 and the five-scale
protocol (`generate_semantics.segment`); `intersection_and_union`
accumulates. --result-dir writes each frame's img | gt | pred grid as an RGB
PNG (VAL.visualize). The run is on the card unless --device cpu; a missing
card is an error.
"""

import argparse
import json
import os

import numpy as np

from ..data.decode import read_png, read_rgb, write_png
from ..ops.metrics import intersection_and_union
from ..utils.graphs import color_encode, load_color150
from .generate_semantics import COMPUTE_DTYPE, device_of, segment
from .hrnet import load_hrnet_c1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--odgt", required=True, help="validation odgt list")
    ap.add_argument("--root", default="", help="prefix for the odgt paths")
    ap.add_argument("--encoder-ckpt", required=True)
    ap.add_argument("--decoder-ckpt", required=True)
    ap.add_argument("--num-classes", type=int, default=150)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--result-dir", default=None,
                    help="if set, save img|gt|pred grids like VAL.visualize")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_model(args, device):
    return load_hrnet_c1(args.encoder_ckpt, args.decoder_ckpt, COMPUTE_DTYPE).to(device).eval()


def main(argv=None) -> dict:
    args = parse_args(argv)
    model = build_model(args, device_of(args.device))
    with open(args.odgt) as f:
        samples = [json.loads(line) for line in f]
    if args.max_images:
        samples = samples[:args.max_images]
    inter_sum = np.zeros(args.num_classes, np.float64)
    union_sum = np.zeros(args.num_classes, np.float64)
    acc_sum = pix_sum = 0.0
    colors = load_color150() if args.result_dir else None
    for i, s in enumerate(samples):
        img = read_rgb(os.path.join(args.root, s["fpath_img"])).astype(np.float32) / 255.0
        segm = read_png(os.path.join(args.root, s["fpath_segm"])).astype(np.int64) - 1
        pred = segment(model, img)
        valid = segm >= 0
        acc_sum += float(np.sum((pred == segm) & valid))
        pix_sum += float(np.sum(valid))
        inter, union = intersection_and_union(pred, segm, args.num_classes)
        inter_sum += inter
        union_sum += union
        if args.result_dir:
            os.makedirs(args.result_dir, exist_ok=True)
            vis = np.concatenate([(img * 255).astype(np.uint8), color_encode(segm, colors),
                                  color_encode(pred, colors)], axis=1)
            write_png(os.path.join(args.result_dir, os.path.basename(
                s["fpath_img"]).replace(".jpg", ".png")), vis)
        if i % 20 == 0:
            seen = union_sum > 0
            miou_sofar = np.mean(inter_sum[seen] / union_sum[seen]) if seen.any() else float("nan")
            print(f"[{i}/{len(samples)}] running mIoU {miou_sofar:.4f} "
                  f"acc {acc_sum / max(pix_sum, 1):.4f}")
    iou = np.full(args.num_classes, np.nan)
    seen = union_sum > 0
    iou[seen] = inter_sum[seen] / union_sum[seen]
    for c in range(args.num_classes):
        print(f"class [{c}], IoU: {iou[c]:.4f}")
    miou, acc = float(np.nanmean(iou)), 100.0 * acc_sum / max(pix_sum, 1)
    print("[Eval Summary]:")
    print(f"Mean IoU: {miou:.4f}, Accuracy: {acc:.2f}%")
    return {"mIoU": miou, "accuracy": acc, "iou": iou}


if __name__ == "__main__":
    main()
