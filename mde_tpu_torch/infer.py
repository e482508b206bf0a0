"""Library inference API, port of `mde_tpu/infer.py` (reference infer.py:66-149).

InferenceHelper: single-image / array / directory prediction with
horizontal-flip TTA averaging, bin-center extraction and 16-bit png saving
(x1000 nyu, x256 kitti). The flip-TTA pair runs as one batch-2 forward
([image, flipped image]); the model takes the fused bins head, so a CUDA
device runs the bins-head kernel once per request.

Run `python -m mde_tpu_torch.infer [image] [checkpoint] [--device cpu]` for
the demo; it runs on the card unless `--device` says otherwise.
"""

import glob
import os

import numpy as np
import torch

from .checkpoint import load_reference_checkpoint
from .data.decode import read_rgb, write_png
from .data.transforms import normalize_image
from .models import UnetAdaptiveBins
from .ops.resize import resize_bilinear_align_corners


class InferenceHelper:
    def __init__(self, dataset: str = "nyu", checkpoint_path: str = None,
                 n_bins: int = 256, encoder_name: str = "efficientnet-b1",
                 state_dict=None, device=torch.device("cuda")):
        if dataset == "nyu":
            self.min_depth, self.max_depth, self.saving_factor = 1e-3, 10, 1000
        elif dataset == "kitti":
            self.min_depth, self.max_depth, self.saving_factor = 1e-3, 80, 256
        else:
            raise ValueError(f"dataset can be either 'nyu' or 'kitti' but got {dataset}")
        self.device = torch.device(device)
        model = UnetAdaptiveBins(n_bins=n_bins, min_val=self.min_depth,
                                 max_val=self.max_depth, encoder_name=encoder_name,
                                 fused_head=True)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        elif checkpoint_path is not None:
            load_reference_checkpoint(model, checkpoint_path)
        else:
            raise ValueError("provide checkpoint_path or state_dict")
        self.model = model.to(self.device).eval()

    def predict(self, image_nhwc):
        """image: normalized (1, H, W, 3). Returns (bin centers within range,
        depth (1, H, W, 1)) as numpy — reference infer.py:106-130."""
        img = torch.from_numpy(np.asarray(image_nhwc, dtype=np.float32))
        img = img.to(self.device).permute(0, 3, 1, 2)
        with torch.inference_mode():
            both = torch.cat([img, img.flip(3)], dim=0).contiguous()
            bins, pred = self.model(both)
            pred = pred.clamp(self.min_depth, self.max_depth)
            final = 0.5 * (pred[:1] + pred[1:].flip(3))
            final = resize_bilinear_align_corners(final, img.shape[-2:])
            final = final.clamp(self.min_depth, self.max_depth)
            final = torch.where(torch.isinf(final), self.max_depth, final)
            final = torch.where(torch.isnan(final), self.min_depth, final)
            centers = 0.5 * (bins[:1, 1:] + bins[:1, :-1])
        centers = centers.cpu().numpy().squeeze()
        centers = centers[(centers > self.min_depth) & (centers < self.max_depth)]
        return centers, final.permute(0, 2, 3, 1).cpu().numpy()

    def predict_pil(self, pil_image, visualized: bool = False):
        """An (H, W, 3) uint8 image (a PIL image or an array); with
        `visualized`, also the colorized depth as an (H, W, 3) uint8 array."""
        img = np.asarray(pil_image, dtype=np.float32) / 255.0
        centers, pred = self.predict(normalize_image(img)[None])
        if visualized:
            from .utils.misc import colorize
            return centers, pred, colorize(pred[0, ..., 0], vmin=None, vmax=None, cmap="magma")
        return centers, pred

    def predict_dir(self, test_dir: str, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        for f in sorted(glob.glob(os.path.join(test_dir, "*"))):
            image = read_rgb(f).astype(np.float32) / 255.0
            _, final = self.predict(normalize_image(image)[None])
            out = (final[0, ..., 0] * self.saving_factor).astype("uint16")
            basename = os.path.basename(f).split(".")[0]
            write_png(os.path.join(out_dir, basename + ".png"), out)


def main(argv):
    """Single-image demo, as the root `infer.py` (reference infer.py:152-163).
    Runs on the device that `--device` names (default cuda), never elsewhere."""
    import argparse
    from time import time

    parser = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    parser.add_argument("image", nargs="?", default="test_imgs/classroom__rgb_00283.jpg")
    parser.add_argument("checkpoint", nargs="?", default="./pretrained/AdaBins_nyu.pt")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu must be asked for)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    img = read_rgb(args.image)
    start = time()
    helper = InferenceHelper(dataset="nyu", checkpoint_path=args.checkpoint, device=device)
    _, pred = helper.predict_pil(img)
    print(f"took :{time() - start}s on {device}")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.imshow(pred.squeeze(), cmap="magma_r")
    plt.savefig("./thingy.png")


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
