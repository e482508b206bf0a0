"""ctypes binding of the port's host library (`csrc/mdeaug.cpp`: the image
decoders that `data/decode.py` wraps, and the fused augmentation), the
port's counterpart of `mde_tpu/data/native.py`.

The same C layout and the same Python-side random parameters as the JAX
package's engine, so both draw the same values under one seed. The library
is built by `kernels/build.py` at first use; a failed build raises, and
there is no other path to drop back to.
"""

import ctypes
import os
import threading

import numpy as np

from ..kernels import build

SOURCE = "mdeaug.cpp"


class AugParams(ctypes.Structure):
    _fields_ = [
        ("angle_deg", ctypes.c_float),
        ("crop_x", ctypes.c_int32),
        ("crop_y", ctypes.c_int32),
        ("do_flip", ctypes.c_int32),
        ("do_augment", ctypes.c_int32),
        ("gamma", ctypes.c_float),
        ("brightness", ctypes.c_float),
        ("color", ctypes.c_float * 3),
        ("depth_scale", ctypes.c_float),
    ]


class CropRect(ctypes.Structure):
    _fields_ = [("x", ctypes.c_int32), ("y", ctypes.c_int32),
                ("w", ctypes.c_int32), ("h", ctypes.c_int32)]


_ERR_LEN = 512
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The host library, built at first use; a failed build raises."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build.load_host(SOURCE)
            cstr, cint, err = ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p

            def ptrs(ctype):
                return ctypes.POINTER(ctypes.POINTER(ctype))

            signatures = {
                "mdeaug_image_info": ([cstr, _i32p, err, cint], cint),
                "mdeaug_decode_jpeg": ([cstr, ctypes.c_void_p, cint, cint, err, cint], cint),
                "mdeaug_decode_png": ([cstr, ctypes.c_void_p, cint, cint, cint, err, cint],
                                      cint),
                "mdeaug_decode_rgb": ([cstr, ctypes.c_void_p, cint, cint, err, cint], cint),
                "mdeaug_image_info_mem": ([ctypes.c_char_p, ctypes.c_int64, _i32p, err, cint],
                                          cint),
                "mdeaug_decode_rgb_mem": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                           cint, cint, err, cint], cint),
                "mdeaug_fill_polygon": ([ctypes.c_void_p, cint, cint, ctypes.c_void_p, cint],
                                        None),
                "mdeaug_load_augment_batch": (
                    [cint, ctypes.POINTER(cstr), ctypes.POINTER(cstr), ptrs(ctypes.c_int32),
                     ptrs(ctypes.c_int32), ptrs(ctypes.c_int32), ctypes.POINTER(CropRect), cint,
                     cint, ctypes.POINTER(AugParams), _f32p, _f32p, _i32p, _i32p, _i32p, cint,
                     err, cint], cint),
                "mdeaug_augment_batch": (
                    [cint, ptrs(ctypes.c_uint8), ptrs(ctypes.c_uint16), ptrs(ctypes.c_int32),
                     ptrs(ctypes.c_int32), ptrs(ctypes.c_int32), _i32p, _i32p, cint, cint,
                     ctypes.POINTER(AugParams), _f32p, _f32p, _i32p, _i32p, _i32p, cint], None),
            }
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _params_struct(params_list):
    params = (AugParams * len(params_list))()
    for i, p in enumerate(params_list):
        params[i].angle_deg = p.get("angle_deg", 0.0)
        params[i].crop_x = p["crop_x"]
        params[i].crop_y = p["crop_y"]
        params[i].do_flip = int(p.get("do_flip", False))
        params[i].do_augment = int(p.get("do_augment", False))
        params[i].gamma = p.get("gamma", 1.0)
        params[i].brightness = p.get("brightness", 1.0)
        for c in range(3):
            params[i].color[c] = p.get("color", (1.0, 1.0, 1.0))[c]
        params[i].depth_scale = p.get("depth_scale", 1e-3)
    return params


def _pointers(arrays, key, ctype, dtype):
    """Per-sample pointer array for `key` (None where a sample has none) and
    the contiguous arrays that must outlive the call."""
    ptrs = (ctypes.POINTER(ctype) * len(arrays))()
    holders = []
    for i, s in enumerate(arrays):
        if key in s:
            a = np.ascontiguousarray(s[key], dtype=dtype)
            holders.append(a)
            ptrs[i] = a.ctypes.data_as(ctypes.POINTER(ctype))
    return ptrs, holders


def _outputs(b, out_h, out_w, has_sem, has_inst):
    return {"image": np.empty((b, out_h, out_w, 3), np.float32),
            "depth": np.empty((b, out_h, out_w), np.float32),
            "semantics": np.empty((b, out_h, out_w), np.int32) if has_sem else None,
            "instance_labels": np.empty((b, out_h, out_w), np.int32) if has_inst else None,
            "instance_areas": np.empty((b, out_h, out_w), np.int32) if has_inst else None}


def _out_ptr(a, ptype):
    return a.ctypes.data_as(ptype) if a is not None else None


def _nhwc(out):
    return {k: (v[..., None] if v is not None and v.ndim == 3 else v) for k, v in out.items()}


def augment_batch(samples, out_h: int, out_w: int, params_list, num_threads: int = 0):
    """Run the fused augmentation for a batch.

    samples: list of dicts with 'rgb' (H,W,3 u8), 'depth' (H,W u16), and
    optional 'semantics'/'instance_labels'/'instance_areas' (H,W i32), all
    already boundary/kb-cropped. params_list: dicts of AugParams fields.
    Returns a dict of NHWC float32/int32 batch arrays (None for absent cues).
    """
    lib = library()
    b = len(samples)
    has_sem = "semantics" in samples[0]
    has_inst = "instance_labels" in samples[0]
    rgb_ptrs, h1 = _pointers(samples, "rgb", ctypes.c_uint8, np.uint8)
    depth_ptrs, h2 = _pointers(samples, "depth", ctypes.c_uint16, np.uint16)
    sem_ptrs, h3 = _pointers(samples, "semantics", ctypes.c_int32, np.int32) if has_sem \
        else (None, [])
    lab_ptrs, h4 = _pointers(samples, "instance_labels", ctypes.c_int32, np.int32) \
        if has_inst else (None, [])
    area_ptrs, h5 = _pointers(samples, "instance_areas", ctypes.c_int32, np.int32) \
        if has_inst else (None, [])
    in_hs = np.asarray([s["rgb"].shape[0] for s in samples], np.int32)
    in_ws = np.asarray([s["rgb"].shape[1] for s in samples], np.int32)
    out = _outputs(b, out_h, out_w, has_sem, has_inst)
    nt = num_threads or min(b, os.cpu_count() or 1)
    lib.mdeaug_augment_batch(
        ctypes.c_int(b), rgb_ptrs, depth_ptrs, sem_ptrs, lab_ptrs, area_ptrs,
        in_hs.ctypes.data_as(_i32p), in_ws.ctypes.data_as(_i32p),
        ctypes.c_int(out_h), ctypes.c_int(out_w), _params_struct(params_list),
        _out_ptr(out["image"], _f32p), _out_ptr(out["depth"], _f32p),
        _out_ptr(out["semantics"], _i32p), _out_ptr(out["instance_labels"], _i32p),
        _out_ptr(out["instance_areas"], _i32p), ctypes.c_int(nt))
    del h1, h2, h3, h4, h5
    return _nhwc(out)


def load_augment_batch(rgb_paths, depth_paths, cue_maps, rects, out_h: int,
                       out_w: int, params_list, num_threads: int = 0):
    """Fully-native batch: file read + JPEG/PNG decode + pre-crop + augment
    in C++ threads (mdeaug_load_augment_batch). cue_maps is a list of dicts
    (full-frame int32 arrays, or empty dicts); rects is a list of
    (x, y, w, h) pre-crop windows or None for the full frame.

    Returns the batch dict; a sample that fails to decode raises IOError
    with the decoder's message."""
    lib = library()
    b = len(rgb_paths)
    has_sem = any("semantics" in c for c in cue_maps)
    has_inst = any("instance_labels" in c for c in cue_maps)
    sem_ptrs, h1 = _pointers(cue_maps, "semantics", ctypes.c_int32, np.int32) if has_sem \
        else (None, [])
    lab_ptrs, h2 = _pointers(cue_maps, "instance_labels", ctypes.c_int32, np.int32) \
        if has_inst else (None, [])
    area_ptrs, h3 = _pointers(cue_maps, "instance_areas", ctypes.c_int32, np.int32) \
        if has_inst else (None, [])
    rgb_arr = (ctypes.c_char_p * b)(*[os.fsencode(p) for p in rgb_paths])
    depth_arr = (ctypes.c_char_p * b)(*[os.fsencode(p) for p in depth_paths])
    crects = (CropRect * b)()
    for i, r in enumerate(rects):
        crects[i] = CropRect(0, 0, -1, -1) if r is None else CropRect(*[int(v) for v in r])
    out = _outputs(b, out_h, out_w, has_sem, has_inst)
    err = ctypes.create_string_buffer(_ERR_LEN)
    nt = num_threads or min(b, os.cpu_count() or 1)
    nfail = lib.mdeaug_load_augment_batch(
        ctypes.c_int(b), rgb_arr, depth_arr, sem_ptrs, lab_ptrs, area_ptrs,
        crects, ctypes.c_int(out_h), ctypes.c_int(out_w), _params_struct(params_list),
        _out_ptr(out["image"], _f32p), _out_ptr(out["depth"], _f32p),
        _out_ptr(out["semantics"], _i32p), _out_ptr(out["instance_labels"], _i32p),
        _out_ptr(out["instance_areas"], _i32p), ctypes.c_int(nt), err, ctypes.c_int(_ERR_LEN))
    del h1, h2, h3
    if nfail:
        raise IOError(f"native loader failed to decode {nfail} of {b} samples: "
                      f"{err.value.decode(errors='replace')}")
    return _nhwc(out)
