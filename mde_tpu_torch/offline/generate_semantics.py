"""Semantic cue maps over an NYUD2 tree, the port of
`scripts/generate_semantics.py` (the reference's demo_test.sh +
semantic-segmentation-pytorch/test.py:30-101):

    python -m mde_tpu_torch.offline.generate_semantics --images data/nyu/sync \\
        --encoder-ckpt encoder_epoch_30.pth --decoder-ckpt decoder_epoch_30.pth
    python -m mde_tpu_torch.offline.generate_semantics --images DIR --random-init 0

For every rgb_*.jpg under --images (recursively, sorted), writes
semantic_seg_*.npy beside it (the path with every "rgb" replaced): the
(H, W) uint8 argmax of HRNetV2-W48 + C1's softmax summed over five scales,
in bfloat16 (float32 norms, logits and scores). An existing file is kept
unless --overwrite. Frames are decoded by the port's JPEG decoder and
resized by its PIL-exact resize. The run is on the card unless --device cpu;
a missing card is an error, and so is a checkpoint that does not load.
"""

import argparse
import glob
import os

import numpy as np
import torch

from ..data.decode import read_rgb
from .hrnet import HRNetV2C1, hrnet_multiscale_inference, load_hrnet_c1
from .semseg_zoo import SegmentationModel
from .layers import seeded, to_compute_dtype

COMPUTE_DTYPE = torch.bfloat16


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True, help="root dir scanned for rgb_*.jpg")
    ap.add_argument("--encoder-ckpt", default=None)
    ap.add_argument("--decoder-ckpt", default=None)
    ap.add_argument("--random-init", type=int, default=None, metavar="SEED",
                    help="no checkpoint: weights drawn from SEED as flax initialises "
                         "them (system runs of the offline -> side-file -> cue-training "
                         "loop where no released checkpoint is at hand)")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.random_init is None and not (args.encoder_ckpt and args.decoder_ckpt):
        ap.error("--encoder-ckpt/--decoder-ckpt required unless --random-init")
    return args


def device_of(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return device


def build_model(args, device) -> SegmentationModel:
    if args.random_init is not None:
        model = to_compute_dtype(seeded(HRNetV2C1, args.random_init), COMPUTE_DTYPE)
    else:
        model = load_hrnet_c1(args.encoder_ckpt, args.decoder_ckpt, COMPUTE_DTYPE)
    return model.to(device).eval()


def segment(model: SegmentationModel, img_hwc01: np.ndarray) -> np.ndarray:
    """One frame's (H, W) class map: the multiscale protocol on `model`."""
    device = next(model.parameters()).device

    def apply_fn(x, seg_size):
        return model(x.to(device, non_blocking=True), seg_size)

    with torch.inference_mode():
        return hrnet_multiscale_inference(apply_fn, img_hwc01)


def main(argv=None):
    args = parse_args(argv)
    model = build_model(args, device_of(args.device))
    files = sorted(glob.glob(os.path.join(args.images, "**", "rgb_*.jpg"), recursive=True))
    print(f"{len(files)} images")
    for i, f in enumerate(files):
        out_path = f.replace("rgb", "semantic_seg").replace(".jpg", ".npy")
        if os.path.exists(out_path) and not args.overwrite:
            continue
        img = read_rgb(f).astype(np.float32) / 255.0
        np.save(out_path, segment(model, img).astype(np.uint8))
        if i % 50 == 0:
            print(f"{i}/{len(files)} -> {out_path}")


if __name__ == "__main__":
    main()
