"""Port parity, ops: mde_tpu_torch.ops against mde_tpu.ops (CPU, float32),
and the port's import boundary (no jax, no flax, no mde_tpu, no PIL: the
card's machine has no Pillow, so the port decodes images itself).

Tolerance rtol 1e-6, with atol 1e-6 for values near zero: the JAX resize is
two f32 matmuls over taps computed in f64, torch's interpolates with taps
computed in f32, so single roundings differ.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.ops import bins as jax_bins
from mde_tpu.ops import resize as jax_resize
from mde_tpu_torch.ops import bins, resize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_MODULES = ["mde_tpu_torch", "mde_tpu_torch.ops", "mde_tpu_torch.ops.losses",
                 "mde_tpu_torch.ops.metrics", "mde_tpu_torch.cues",
                 "mde_tpu_torch.kernels", "mde_tpu_torch.kernels.build",
                 "mde_tpu_torch.kernels.chamfer", "mde_tpu_torch.models",
                 "mde_tpu_torch.checkpoint", "mde_tpu_torch.data", "mde_tpu_torch.infer",
                 "mde_tpu_torch.train", "mde_tpu_torch.utils", "mde_tpu_torch.config",
                 "mde_tpu_torch.train.driver", "mde_tpu_torch.train.__main__",
                 "mde_tpu_torch.parallel", "mde_tpu_torch.evaluate"]
FORBIDDEN = ("jax", "flax", "orbax", "mde_tpu", "PIL")


def test_port_imports_no_jax_flax_or_pil():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'flax', 'orbax', 'PIL') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def _imported_roots(path):
    """Top-level package of every import in the file, lazy ones included."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


PORT_SOURCES = sorted(Path(REPO, "mde_tpu_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax_flax_or_mde_tpu(path):
    """Static: walks the AST, so an import inside a function counts too."""
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def _widths(seed, n=2, n_bins=256):
    w = np.random.default_rng(seed).random((n, n_bins), dtype=np.float32)
    return w / w.sum(1, keepdims=True)


@pytest.mark.parametrize("n_bins", [80, 256])
def test_bin_edges_and_centers_match_jax(n_bins):
    w = _widths(0, n_bins=n_bins)
    want_edges = jax_bins.bin_edges_from_widths(jnp.asarray(w), 1e-3, 10.0)
    got_edges = bins.bin_edges_from_widths(torch.from_numpy(w), 1e-3, 10.0)
    np.testing.assert_allclose(got_edges.numpy(), np.asarray(want_edges), rtol=1e-6)
    np.testing.assert_allclose(bins.bin_centers(got_edges).numpy(),
                               np.asarray(jax_bins.bin_centers(want_edges)), rtol=1e-6)


def test_depth_from_bins_matches_jax():
    rng = np.random.default_rng(1)
    probs = rng.random((2, 9, 11, 64), dtype=np.float32)
    probs /= probs.sum(-1, keepdims=True)
    centers = rng.random((2, 64), dtype=np.float32) * 10
    want = jax_bins.depth_from_bins(jnp.asarray(probs), jnp.asarray(centers))
    got = bins.depth_from_bins(torch.from_numpy(probs.transpose(0, 3, 1, 2)),
                               torch.from_numpy(centers))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-6)


RESIZES = [((7, 9), (15, 17)), ((33, 49), (66, 98)), ((240, 320), (480, 640)),
           ((20, 30), (7, 11)), ((1, 5), (4, 8)), ((6, 6), (6, 6))]


def _image(seed, hw, c=3):
    return np.random.default_rng(seed).standard_normal((2, *hw, c)).astype(np.float32)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_bilinear_align_corners_matches_jax(src, dst):
    x = _image(2, src, c=1 if src == (240, 320) else 3)
    want = jax_resize.resize_bilinear_align_corners(jnp.asarray(x), dst)
    got = resize.resize_bilinear_align_corners(torch.from_numpy(x.transpose(0, 3, 1, 2)), dst)
    assert tuple(got.shape[-2:]) == dst
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((480, 640), (240, 320)), ((13, 17), (5, 7)),
                                     ((5, 7), (13, 17)), ((6, 6), (6, 6))])
def test_nearest_matches_jax(src, dst):
    x = _image(3, src)
    want = jax_resize.resize_nearest(jnp.asarray(x), dst)
    got = resize.resize_nearest(torch.from_numpy(x.transpose(0, 3, 1, 2)), dst)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), np.asarray(want))
