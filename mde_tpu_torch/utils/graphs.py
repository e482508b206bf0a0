"""Qualitative figure grids and the semantic colourisers, the port of
`mde_tpu/utils/graphs.py` (reference GraphBuilder_NYUD2.py:9-108 and
train.py:117-209), numpy and scipy only: the card's machine has no
matplotlib.

Each panel is the pixel array that the JAX builder hands to `imshow`,
coloured as matplotlib colours it (`utils/colormaps.py`): the RGB
min/max-normalised per sample, the GT and the prediction through
`inferno_r` over the GT's range, and the optional semantics and
instance-class columns through the ADE20K colour table. The grid places
each panel at its own size, top left in a cell of the largest panel's size,
with fixed white gutters: no titles and no resampling, where the JAX figure
draws titles and scales every panel to its axes.
"""

import os

import numpy as np

from .colormaps import imshow_rgba

_COLOR150 = os.path.join(os.path.dirname(__file__), "..", "..", "data", "color150.mat")
GUTTER = 8  # pixels between cells
BACKGROUND = 255


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


def visualize_semantics(semantics_n1hw_or_nhw1: np.ndarray) -> np.ndarray:
    """Batch label maps, (N, 1, H, W) or (N, H, W, 1) -> (N, H, W, 3) uint8
    colour images (reference train.py:117-141)."""
    sem = np.asarray(semantics_n1hw_or_nhw1)
    if sem.ndim == 4:
        sem = sem[..., 0] if sem.shape[-1] == 1 else sem[:, 0]
    colors = load_color150()
    return np.stack([color_encode(s, colors) for s in sem], axis=0)


class GraphBuilderNYUD2:
    """num_samples x (3..5) grid: RGB | GT depth | pred depth
    [| semantics | instance classes], as (H, W, 4) uint8 RGBA panels."""

    def __init__(self, num_samples: int, semantics: bool = False,
                 instance_labels: bool = False):
        self.num_samples = num_samples
        self.semantics = semantics
        self.instance_labels = instance_labels
        self.num_columns = 3 + int(semantics) + int(instance_labels)
        self.reset()

    def add_image(self, rgbs_nhwc, gt_depth_nhwc, pred_nhwc,
                  semantics=None, instance_labels=None):
        """All arrays NHWC numpy; semantics / instance_labels are (N, H, W, 3)
        pre-coloured maps (see visualize_semantics)."""
        if self.curr_sample > self.num_samples:
            return
        rgbs = np.asarray(rgbs_nhwc)
        gt = np.asarray(gt_depth_nhwc)[..., 0]
        pred = np.asarray(pred_nhwc)[..., 0]
        n = min(self.num_samples, rgbs.shape[0])
        for i in range(n):
            rgb = rgbs[i]
            rgb = (rgb - rgb.min()) / max(rgb.max() - rgb.min(), 1e-8)
            row = [imshow_rgba(rgb)]
            vmin, vmax = gt[i].min(), gt[i].max()
            row.append(imshow_rgba(gt[i], vmin, vmax, "inferno_r"))
            row.append(imshow_rgba(pred[i], vmin, vmax, "inferno_r"))
            for cue in (semantics, instance_labels):
                if cue is not None:
                    row.append(imshow_rgba(np.asarray(cue)[i]))
            self.panels[i] = row
        self.curr_sample = n

    def image(self) -> np.ndarray:
        """The grid as (H, W, 3) uint8 RGB on white: transparent pixels (a
        masked value's bad colour) show the background."""
        filled = [p for row in self.panels for p in row]
        cell_h = max(p.shape[0] for p in filled)
        cell_w = max(p.shape[1] for p in filled)
        rows, cols = self.num_samples, self.num_columns
        out = np.full((rows * cell_h + (rows - 1) * GUTTER,
                       cols * cell_w + (cols - 1) * GUTTER, 3), BACKGROUND, np.uint8)
        for i, row in enumerate(self.panels):
            for j, panel in enumerate(row):
                y, x = i * (cell_h + GUTTER), j * (cell_w + GUTTER)
                h, w = panel.shape[:2]
                opaque = panel[..., 3:] == 255
                out[y:y + h, x:x + w] = np.where(opaque, panel[..., :3], BACKGROUND)
        return out

    def reset(self):
        self.panels = [[] for _ in range(self.num_samples)]
        self.curr_sample = 0
