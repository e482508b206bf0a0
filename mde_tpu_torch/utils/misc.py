"""Small host-side utilities, the port's own copy of what it needs from
`mde_tpu/utils/misc.py` (reference utils.py:15-116)."""

import os
import shutil
import sys

import numpy as np

from .colormaps import apply_colormap

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def denormalize(x_nhwc):
    """Undo ImageNet normalization on an NHWC array (reference utils.py:69-72)."""
    return x_nhwc * IMAGENET_STD + IMAGENET_MEAN


def count_parameters(model) -> int:
    """Total parameter count of a torch module."""
    return sum(p.numel() for p in model.parameters())


def colorize(value_hw, vmin=10, vmax=1000, cmap="magma_r", invalid_value=-1):
    """Depth map (H, W) -> uint8 RGB through a colormap of `utils/colormaps.py`
    (magma, inferno or their `_r` maps), as matplotlib colours it
    (reference utils.py:92-112)."""
    value = np.asarray(value_hw)
    invalid_mask = value == invalid_value

    vmin = value.min() if vmin is None else vmin
    vmax = value.max() if vmax is None else vmax
    if vmin != vmax:
        value = (value - vmin) / (vmax - vmin)
    else:
        value = value * 0.0
    value = apply_colormap(cmap, value)
    value[invalid_mask] = 255
    return value[:, :, :3]


def setup_exp_dir(root, exp_name, interactive=True):
    """Create or validate the experiment directory (reference utils.py:15-53).

    With interactive=False an existing directory is reused without prompting
    instead of blocking a headless job on stdin.
    """
    if not os.path.isdir(root):
        sys.exit("Error: Supplied output directory does not exist or is a file.")

    exp_path = os.path.join(root, exp_name)
    if os.path.isdir(exp_path):
        if not interactive:
            return exp_path
        print("Experiment directory exists: " + exp_path)
        answer = None
        while answer not in ("delete", "n"):
            answer = input('Wipe and recreate it? ["delete"/"n"]: ')
            if answer == "delete":
                shutil.rmtree(exp_path)
                os.mkdir(exp_path)
                print("Recreated " + exp_path)
            elif answer == "n":
                ans2 = None
                while ans2 not in ("exit", "keep writing"):
                    ans2 = input('Abort ("exit") or append to the existing '
                                 'directory ("keep writing")? : ')
                    if ans2 == "exit":
                        sys.exit("Exiting without touching " + exp_path)
                    elif ans2 == "keep writing":
                        return exp_path
    else:
        os.makedirs(exp_path, exist_ok=True)
    return exp_path
