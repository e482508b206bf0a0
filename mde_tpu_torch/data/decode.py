"""Image files to numpy arrays and back, the port's stand-in for every
`Image.open` of `mde_tpu/data/dataset.py` (:107-108, :152-153, :221, :240,
and the header read at :404) and for the PNG `Image.save` of
`mde_tpu/infer.py`.

The decoders are the port's own, in `csrc/mdeaug.cpp` (built with the host
compiler by `kernels/build.py`, linked against zlib only): baseline JPEG
with libjpeg's ISLOW IDCT, fancy upsampling and YCbCr->RGB, so a frame
decodes to the bytes PIL gives, and non-interlaced 8/16-bit grayscale or
8-bit RGB PNG. A file they cannot read raises `IOError` with the decoder's
message; there is no other path. `write_png` writes a grayscale PNG (8- or
16-bit) with Python's zlib.
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
    out = np.empty((h, w, 3) if channels == 3 else (h, w),
                   np.uint8 if channels == 3 else np.uint16)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().mdeaug_decode_png(str(path).encode(), out.ctypes.data, h, w, channels,
                                       err, _ERR_LEN), err, path)
    return out


def read_rgb(path) -> np.ndarray:
    """An RGB frame, JPEG or 8-bit RGB PNG, as (H, W, 3) uint8."""
    kind, h, w, channels = _info(path)
    if channels != 3:
        raise IOError(f"{path}: not an RGB image")
    if kind == _PNG:
        return read_png(path)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().mdeaug_decode_jpeg(str(path).encode(), out.ctypes.data, h, w,
                                        err, _ERR_LEN), err, path)
    return out


def write_png(path, array) -> None:
    """Write an (H, W) uint8 or uint16 array as a grayscale PNG (filter 0,
    one IDAT)."""
    a = np.asarray(array)
    if a.ndim != 2 or a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes an (H, W) uint8 or uint16 array, not "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape
    rows = a.astype(">u2" if a.dtype == np.uint16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8 * a.itemsize, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
