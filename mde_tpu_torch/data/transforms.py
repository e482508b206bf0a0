"""Host-side sample transforms for the NYUD2/KITTI pipeline, the port's own
copy of `mde_tpu/data/transforms.py` (numpy, no framework).

Numpy re-derivations of the PIL/torchvision chain in reference
dataloader.py:86-521: decode -> (kb_crop) -> nyu boundary crop -> random
rotate -> scale -> random crop -> flip -> photometric jitter -> ImageNet
normalize. Per-sample numpy RNG (seeded per epoch/index) keeps the pipeline
reproducible; rotation matches PIL.Image.rotate's inverse-map bilinear/nearest
sampling. Everything stays HWC uint8/float32 until batch assembly.
"""

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_image(img_hwc: np.ndarray) -> np.ndarray:
    """ImageNet mean/std normalization of an (H, W, 3) image in [0, 1]
    (reference dataloader.py:530)."""
    return (img_hwc - IMAGENET_MEAN) / IMAGENET_STD


def rotate(arr_hwc: np.ndarray, angle_deg: float, nearest: bool = False,
           fill: float = 0.0) -> np.ndarray:
    """PIL.Image.rotate(angle, expand=False) semantics: rotate about the
    center, same output size, bilinear or nearest resampling, zero fill
    (reference dataloader.py:371-373).

    PIL rotates counter-clockwise for positive angles; it builds the inverse
    affine map from output to input coordinates around the image center.
    """
    h, w = arr_hwc.shape[:2]
    theta = np.deg2rad(angle_deg)
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    # PIL uses center (w/2, h/2) and inverse rotation matrix
    # [cos, sin; -sin, cos] mapping output (x,y) -> input coords.
    cx, cy = w / 2.0, h / 2.0
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    # PIL's affine grid samples at integer output coords + 0.5 offset handling:
    # x_in = cos*(x+0.5-cx) + sin*(y+0.5-cy) + cx - 0.5 (matrix offset form)
    xo = xs + 0.5 - cx
    yo = ys + 0.5 - cy
    xi = cos_t * xo - sin_t * yo + cx - 0.5
    yi = sin_t * xo + cos_t * yo + cy - 0.5

    if nearest:
        xr = np.round(xi).astype(np.int64)
        yr = np.round(yi).astype(np.int64)
        valid = (xr >= 0) & (xr < w) & (yr >= 0) & (yr < h)
        xr = np.clip(xr, 0, w - 1)
        yr = np.clip(yr, 0, h - 1)
        out = arr_hwc[yr, xr]
        out[~valid] = fill
        return out

    x0 = np.floor(xi).astype(np.int64)
    y0 = np.floor(yi).astype(np.int64)
    fx = (xi - x0)[..., None] if arr_hwc.ndim == 3 else xi - x0
    fy = (yi - y0)[..., None] if arr_hwc.ndim == 3 else yi - y0

    def sample(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = arr_hwc[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float64)
        if arr_hwc.ndim == 3:
            v[~valid] = fill
        else:
            v = np.where(valid, v, fill)
        return v

    out = (sample(y0, x0) * (1 - fx) * (1 - fy)
           + sample(y0, x0 + 1) * fx * (1 - fy)
           + sample(y0 + 1, x0) * (1 - fx) * fy
           + sample(y0 + 1, x0 + 1) * fx * fy)
    return out.astype(np.float32)


def random_crop(rng: np.random.Generator, height: int, width: int, *arrays):
    """Shared random crop across all aligned maps (reference dataloader.py:376-436)."""
    h, w = arrays[0].shape[:2]
    if h < height or w < width:
        raise ValueError(f"cannot crop {height}x{width} from {h}x{w}")
    x = int(rng.integers(0, w - width + 1))
    y = int(rng.integers(0, h - height + 1))
    return tuple(a[y:y + height, x:x + width] for a in arrays)


def random_flip(rng: np.random.Generator, *arrays):
    """Shared horizontal flip with p=0.5 (reference dataloader.py:439-499)."""
    if rng.random() > 0.5:
        return tuple(np.ascontiguousarray(a[:, ::-1]) for a in arrays)
    return arrays


def augment_image(rng: np.random.Generator, image: np.ndarray, dataset: str) -> np.ndarray:
    """Gamma/brightness/per-channel color jitter, applied with p=0.5 by the
    caller (reference dataloader.py:502-521)."""
    gamma = rng.uniform(0.9, 1.1)
    image_aug = image ** gamma
    if dataset == "nyu":
        brightness = rng.uniform(0.75, 1.25)
    else:
        brightness = rng.uniform(0.9, 1.1)
    image_aug = image_aug * brightness
    colors = rng.uniform(0.9, 1.1, size=3).astype(np.float32)
    image_aug = image_aug * colors[None, None, :]
    return np.clip(image_aug, 0, 1)
