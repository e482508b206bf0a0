"""Image files to numpy arrays and back, the port's stand-in for every
`Image.open` of `mde_tpu/data/dataset.py` (:107-108, :152-153, :221, :240,
and the header read at :404) and for the PNG `Image.save` of
`mde_tpu/infer.py`.

The decoders are the port's own, in `csrc/mdeaug.cpp` (built with the host
compiler by `kernels/build.py`, linked against zlib only): baseline JPEG
with libjpeg's ISLOW IDCT, fancy upsampling and YCbCr->RGB (or one grey
component), so a frame decodes to the bytes PIL gives, and non-interlaced
8/16-bit grayscale, 8-bit RGB, grey-alpha and RGBA PNG. `read_rgb` gives
every 8-bit kind as PIL's `Image.open(...).convert("RGB")`: grey replicated,
alpha dropped; `decode_rgb` does the same for bytes in memory. A file they cannot read raises `IOError` with the decoder's
message and the file's name; there is no other path. `write_png` writes a
grayscale (8- or 16-bit) or an 8-bit RGB PNG with Python's zlib.
"""

import ctypes
import struct
import zlib

import numpy as np

from .native import library

_JPEG, _PNG = 1, 2
_ERR_LEN = 512


def _check(rc: int, err, path) -> None:
    if rc != 0:
        raise IOError(f"{path}: {err.value.decode(errors='replace')}")


def _info(path):
    info = (ctypes.c_int32 * 4)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().mdeaug_image_info(str(path).encode(), info, err, _ERR_LEN), err, path)
    return tuple(info)


def image_size(path) -> tuple:
    """(width, height) of a JPEG or PNG from its header, as PIL's `.size`."""
    _, h, w, _ = _info(path)
    return w, h


def read_png(path) -> np.ndarray:
    """A PNG: grayscale (8- or 16-bit) as (H, W) uint16, RGB as (H, W, 3)
    uint8."""
    kind, h, w, channels = _info(path)
    if kind != _PNG:
        raise IOError(f"{path}: not a PNG file")
    if channels not in (1, 3):
        raise IOError(f"{path}: a PNG with alpha: read it with read_rgb")
    out = np.empty((h, w, 3) if channels == 3 else (h, w),
                   np.uint8 if channels == 3 else np.uint16)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().mdeaug_decode_png(str(path).encode(), out.ctypes.data, h, w, channels,
                                       err, _ERR_LEN), err, path)
    return out


def read_rgb(path) -> np.ndarray:
    """A JPEG (grey or colour) or an 8-bit PNG (grey, grey-alpha, RGB, RGBA)
    as (H, W, 3) uint8 RGB, as PIL's `convert("RGB")` gives it."""
    _, h, w, _ = _info(path)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().mdeaug_decode_rgb(str(path).encode(), out.ctypes.data, h, w, err,
                                       _ERR_LEN), err, path)
    return out


def decode_rgb(data: bytes) -> np.ndarray:
    """`read_rgb` of an image held in memory (a JPEG's or a PNG's bytes)."""
    data = bytes(data)
    info = (ctypes.c_int32 * 4)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = library()
    _check(lib.mdeaug_image_info_mem(data, len(data), info, err, _ERR_LEN), err, "image bytes")
    _, h, w, _ = tuple(info)
    out = np.empty((h, w, 3), np.uint8)
    _check(lib.mdeaug_decode_rgb_mem(data, len(data), out.ctypes.data, h, w, err, _ERR_LEN),
           err, "image bytes")
    return out


def write_png(path, array) -> None:
    """Write an (H, W) uint8 or uint16 array as a grayscale PNG, or an
    (H, W, 3) uint8 array as an RGB PNG (filter 0, one IDAT)."""
    a = np.asarray(array)
    rgb = a.ndim == 3 and a.shape[2] == 3 and a.dtype == np.uint8
    if not rgb and (a.ndim != 2 or a.dtype not in (np.uint8, np.uint16)):
        raise ValueError(f"write_png takes an (H, W) uint8 or uint16 array or an (H, W, 3) "
                         f"uint8 one, not {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = a.astype(">u2" if a.dtype == np.uint16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8 * a.itemsize, 2 if rgb else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def fill_polygon(plane: np.ndarray, xy) -> None:
    """Fill one polygon with 1 in the (H, W) uint8 `plane`, in place, as PIL's
    `ImageDraw.Draw(img).polygon(xy, outline=1, fill=1)` on an "L" image
    (the outline adds nothing where it equals the fill). `xy` is the flat
    [x0, y0, x1, y1, ...] float coordinates."""
    if plane.dtype != np.uint8 or plane.ndim != 2 or not plane.flags.c_contiguous:
        raise ValueError("fill_polygon takes a C-contiguous (H, W) uint8 plane")
    pts = np.ascontiguousarray(xy, np.float64).reshape(-1)
    library().mdeaug_fill_polygon(plane.ctypes.data, plane.shape[0], plane.shape[1],
                                  pts.ctypes.data, pts.size // 2)
