"""The semantic colour table and colouriser of `mde_tpu/utils/graphs.py`
(:19-36; the reference's train.py:41, :190-209), for `eval_semseg
--result-dir`. numpy and scipy only: the card's machine has no matplotlib,
and the figure grids stay to be ported.
"""

import os

import numpy as np

_COLOR150 = os.path.join(os.path.dirname(__file__), "..", "..", "data", "color150.mat")


def load_color150() -> np.ndarray:
    """ADE20K's 150-class colour table from data/color150.mat, (150, 3) uint8."""
    from scipy.io import loadmat
    return loadmat(_COLOR150)["colors"]


def color_encode(labelmap_hw: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """An integer label map (H, W) -> (H, W, 3) uint8; labels < 0 stay black."""
    labelmap = labelmap_hw.astype(int)
    out = np.zeros((*labelmap.shape, 3), dtype=np.uint8)
    valid = labelmap >= 0
    idx = np.clip(labelmap, 0, len(colors) - 1)
    out[valid] = colors[idx[valid]]
    return out
