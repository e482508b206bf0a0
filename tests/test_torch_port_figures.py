"""Port parity, the pictures and the demo utilities: mde_tpu_torch.utils.
{colormaps, misc.colorize, graphs, logging.add_figure, pointcloud} against
matplotlib 3.10 and mde_tpu.utils (CPU), all exact.

* The colormap tables and their rule: `apply_colormap` equals
  `matplotlib.colormaps[name](x, bytes=True)` for magma, inferno and their
  `_r` maps on random values in [-0.2, 1.2], on 0, 1, values just below 1,
  under, over, +-inf and NaN, in float32 and float64.
* `colorize` equals `mde_tpu.utils.misc.colorize` bit for bit.
* Every panel of the port's figure grid equals what matplotlib draws into
  JAX's `GraphBuilderNYUD2` (`ax[i, j].images[0].to_rgba(get_array(),
  bytes=True)`), with and without the cue columns, and the grid holds each
  panel at its cell; `visualize_semantics` is equal.
* `SummaryLogger.add_figure` writes `{tag}_{step}.png` (decoded back equal)
  and the JSONL line {"t", "tag", "figure", "step"}.
* `pointcloud`: `edges`, `world_coords`, `depth_to_points` (its NaNs and
  its mutation of the depth) equal JAX's; `b64_to_pil` of a PNG and a JPEG
  data URL equals PIL's array.
"""

import base64
import io
import json
import sys

import matplotlib
import numpy as np
import pytest
from PIL import Image

from mde_tpu.utils import graphs as jax_graphs
from mde_tpu.utils import misc as jax_misc
from mde_tpu.utils import pointcloud as jax_pointcloud
from mde_tpu_torch.data import read_png
from mde_tpu_torch.utils import graphs, misc, pointcloud
from mde_tpu_torch.utils.colormaps import apply_colormap
from mde_tpu_torch.utils.logging import SummaryLogger

matplotlib.use("Agg")

CMAPS = ("magma", "magma_r", "inferno", "inferno_r")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_colormaps_equal_matplotlib(dtype):
    rng = np.random.default_rng(0)
    edges = [0.0, 1.0, np.nextafter(dtype(1), dtype(0)), 1 - 1e-7, 0.99999, -1e-9, -0.5,
             1.0000001, 2.0, np.inf, -np.inf, np.nan, 0.5 / 256, 255.5 / 256]
    x = np.concatenate([rng.uniform(-0.2, 1.2, 4000), np.asarray(edges)]).astype(dtype)
    x = x.reshape(-1, 2)  # a 2-D map, as the pictures give
    for name in CMAPS:
        want = matplotlib.colormaps[name](x, bytes=True)
        got = apply_colormap(name, x)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_colorize_equals_jax():
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 9.5, (31, 47)).astype(np.float32)
    depth[3, :5] = -1  # the invalid value
    depth[4, :3] = 0.5  # the minimum
    for kw in (dict(), dict(vmin=None, vmax=None, cmap="magma"),
               dict(vmin=1.0, vmax=8.0, cmap="inferno_r"), dict(vmin=2, vmax=2)):
        np.testing.assert_array_equal(misc.colorize(depth, **kw),
                                      jax_misc.colorize(depth, **kw), err_msg=str(kw))


def _figure_inputs(cues):
    """Two samples: normalised images and GT at 48x64, predictions at 24x32
    (the model's half resolution), a GT with zeros; label maps for the cue
    columns (with -1 and labels past the table)."""
    rng = np.random.default_rng(2)
    rgb = rng.standard_normal((2, 48, 64, 3)).astype(np.float32)
    gt = rng.uniform(0.5, 9.0, (2, 48, 64, 1)).astype(np.float32)
    gt[0, :6] = 0.0
    pred = rng.uniform(0.1, 10.0, (2, 24, 32, 1)).astype(np.float32)
    if not cues:
        return rgb, gt, pred, None, None
    labels = rng.integers(-1, 160, (2, 1, 48, 64))
    return (rgb, gt, pred, graphs.visualize_semantics(labels),
            graphs.visualize_semantics(labels[:, :, ::-1].transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("cues", [False, True])
def test_figure_panels_equal_matplotlib(cues):
    rgb, gt, pred, sem, inst = _figure_inputs(cues)
    want = jax_graphs.GraphBuilderNYUD2(2, semantics=cues, instance_labels=cues)
    want.add_image(rgb, gt, pred, semantics=sem, instance_labels=inst)
    got = graphs.GraphBuilderNYUD2(2, semantics=cues, instance_labels=cues)
    got.add_image(rgb, gt, pred, semantics=sem, instance_labels=inst)
    image = got.image()
    assert got.num_columns == want.num_columns == (5 if cues else 3)
    cell_h, cell_w = 48 + graphs.GUTTER, 64 + graphs.GUTTER
    assert image.shape == (2 * 48 + graphs.GUTTER, want.num_columns * cell_w - graphs.GUTTER, 3)
    for i in range(2):
        for j in range(want.num_columns):
            im = want.ax[i, j].images[0]
            expected = im.to_rgba(im.get_array(), bytes=True)
            panel = got.panels[i][j]
            np.testing.assert_array_equal(panel, expected, err_msg=f"panel {i}, {j}")
            h, w = panel.shape[:2]
            np.testing.assert_array_equal(
                image[i * cell_h:i * cell_h + h, j * cell_w:j * cell_w + w], panel[..., :3])
    assert (image[48:48 + graphs.GUTTER] == 255).all()  # the gutter between rows
    assert (image[:24, 2 * cell_w + 32:3 * cell_w - graphs.GUTTER] == 255).all()  # pred cell
    want.reset()
    got.reset()
    assert got.panels == [[], []] and got.curr_sample == 0


def test_visualize_semantics_equals_jax():
    labels = np.random.default_rng(3).integers(-3, 170, (3, 1, 17, 23))
    for layout in (labels, labels.transpose(0, 2, 3, 1)):
        np.testing.assert_array_equal(graphs.visualize_semantics(layout),
                                      jax_graphs.visualize_semantics(layout))


def test_add_figure_writes_the_png_and_its_jsonl_line(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorFlow costs ~13 s
    image = np.random.default_rng(4).integers(0, 255, (9, 13, 3), dtype=np.uint8)
    logger = SummaryLogger(str(tmp_path))
    logger.add_scalar("Train/Loss", 1.5, 500)
    logger.add_figure("Train/QualSamples", image, 500)
    logger.close()
    path = tmp_path / "Train_QualSamples_500.png"
    np.testing.assert_array_equal(read_png(path), image)
    lines = [json.loads(line) for line in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert sorted(lines[1]) == ["figure", "step", "t", "tag"]
    assert (lines[1]["tag"], lines[1]["figure"], lines[1]["step"]) == \
        ("Train/QualSamples", str(path), 500)


def test_pointcloud_equals_jax():
    depth = np.random.default_rng(5).uniform(0.5, 4.0, (24, 32))
    depth[8:12, 10:20] += 2.0  # an occlusion edge, masked by NaN
    np.testing.assert_array_equal(pointcloud.edges(depth), jax_pointcloud.edges(depth))
    for got, want in zip(pointcloud.PointCloudHelper.world_coords(32, 24),
                         jax_pointcloud.PointCloudHelper.worldCoords(32, 24)):
        np.testing.assert_array_equal(got, want)
    mine, theirs = depth.copy(), depth.copy()
    got = pointcloud.PointCloudHelper(32, 24).depth_to_points(mine)
    want = jax_pointcloud.PointCloudHelper(32, 24).depth_to_points(theirs)
    assert got.shape == (24 * 32, 3) and np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mine, theirs)  # mutated in place alike
    assert np.isnan(mine).sum() == np.isnan(got[:, 2]).sum() > 0


@pytest.mark.parametrize("kind", ["PNG", "JPEG"])
def test_b64_to_pil_equals_pil(kind):
    rng = np.random.default_rng(6)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (21, 34, 3), dtype=np.uint8)).save(buf, kind)
    url = f"data:image/{kind.lower()};base64," + base64.b64encode(buf.getvalue()).decode()
    got = pointcloud.b64_to_pil(url)
    assert got.dtype == np.uint8 and got.shape == (21, 34, 3)
    np.testing.assert_array_equal(got, np.asarray(jax_pointcloud.b64_to_pil(url)))
    raw = base64.b64encode(buf.getvalue()).decode()  # without the data-URL prefix
    np.testing.assert_array_equal(pointcloud.b64_to_pil(raw), got)
