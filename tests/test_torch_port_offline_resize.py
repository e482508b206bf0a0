"""Port parity, the offline generators' resizes: the PIL-exact bilinear
resize against Pillow, the instance generator's `preprocess` against
`scripts/generate_instances.py::preprocess`, the half-pixel resize against
mde_tpu.ops.resize, and the position-table resize against
mde_tpu.offline.swin_convert (CPU).

The PIL resize and `preprocess` are held bit for bit (the card's machine
has no Pillow, so the port reproduces its fixed-point resampler). The
half-pixel resize: rtol 1e-6 / atol 1e-6 in float32 (both sides take the
same float32 taps; the port multiplies in float64, JAX in float32 at
HIGHEST). The bicubic table resize is the same float64 numpy on both sides:
equal.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mde_tpu.offline.swin_convert import resize_rel_pos_table as jax_resize_table
from mde_tpu.ops.resize import resize_bilinear_half_pixel as jax_half_pixel
from mde_tpu_torch.data.transforms import resize_bilinear_pil
from mde_tpu_torch.offline import generate_instances, hrnet, swin
from mde_tpu_torch.ops.resize import resize_bilinear_half_pixel

REPO = Path(__file__).resolve().parent.parent
CLASSROOM = REPO / "test_imgs" / "classroom__rgb_00283.jpg"


@pytest.fixture(scope="module")
def frame():
    return np.asarray(Image.open(CLASSROOM).convert("RGB"))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", REPO / "scripts" / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the five HRNet plan sizes of a 480x640 frame, and the detector's 800x1067
NYU_SIZES = [(tw, th) for (th, tw), _ in hrnet._scale_plan(480, 640)] + [(1067, 800)]


def test_pil_resize_equals_pillow_on_the_nyu_frame(frame):
    assert NYU_SIZES == [(400, 300), (500, 375), (600, 450), (700, 525), (800, 600), (1067, 800)]
    for size in NYU_SIZES + [(641, 479), (640, 480), (320, 480)]:
        want = np.asarray(Image.fromarray(frame).resize(size, Image.BILINEAR))
        got = resize_bilinear_pil(frame, size)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), size


@pytest.mark.parametrize("shape", [(37, 53, 3), (5, 3), (1, 9, 3), (33, 1)])
def test_pil_resize_equals_pillow_at_odd_sizes(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    for size in [(1, 1), (7, 13), (3, 999), (101, 2), (53, 37), (200, 150), (17, 5)]:
        want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear_pil(img, size), want, err_msg=str(size))


def test_preprocess_equals_the_script_bit_for_bit(frame):
    script = _script("generate_instances.py")
    rng = np.random.default_rng(0)
    for img in (frame, rng.integers(0, 256, (375, 500, 3), dtype=np.uint8),
                rng.integers(0, 256, (600, 333, 3), dtype=np.uint8)):
        got = generate_instances.preprocess(img)
        want = script.preprocess(img)
        assert got[1:] == want[1:]
        assert got[0].dtype == want[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])
    assert generate_instances.preprocess(frame)[0].shape == (800, 1088, 3)


@pytest.mark.parametrize("src,dst", [((16, 24), (64, 96)), ((152, 200), (480, 640)),
                                     ((7, 5), (3, 11))])
def test_half_pixel_resize_matches_jax(src, dst):
    x = np.random.default_rng(1).standard_normal((2, 3, *src), dtype=np.float32)
    want = np.asarray(jax.jit(lambda a: jax_half_pixel(a, dst))(x.transpose(0, 2, 3, 1)))
    got = resize_bilinear_half_pixel(torch.from_numpy(x), dst)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)
    bf = resize_bilinear_half_pixel(torch.from_numpy(x).to(torch.bfloat16), dst)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), got.numpy(), rtol=1e-2, atol=2e-2)


def test_rel_pos_table_resize_equals_jax():
    table = np.random.default_rng(2).standard_normal((23 * 23, 4)).astype(np.float32)
    for target in (13 * 13, 31 * 31, 23 * 23):
        np.testing.assert_array_equal(swin.resize_rel_pos_table(table, target),
                                      jax_resize_table(table, target))
    with pytest.raises(ValueError):
        swin.resize_rel_pos_table(table, 50)
