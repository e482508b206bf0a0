"""Demo utilities, the port of `mde_tpu/utils/pointcloud.py` (reference
utils.py:143-181): base64 image decode, depth-edge magnitudes, and depth
to point cloud.

The point-cloud unprojection assumes the Kinect-style NYUD2 field of view
(57 x 43 degrees) and a central principal point; `depth_to_points` masks
strong depth edges with NaN so stitched surfaces don't bridge occlusions in
the demo viewer.
"""

import base64
import math
import re

import numpy as np

from ..data.decode import decode_rgb


def b64_to_pil(b64string: str) -> np.ndarray:
    """A data-URL or raw base64 JPEG / PNG -> (H, W, 3) uint8 RGB, what
    `InferenceHelper.predict_pil` takes (reference utils.py:144-147, which
    returns a PIL image; the card's machine has no Pillow, so the port's own
    decoders read it)."""
    image_data = re.sub("^data:image/.+;base64,", "", b64string)
    return decode_rgb(base64.b64decode(image_data))


def edges(d: np.ndarray) -> np.ndarray:
    """Sobel edge magnitude |dx| + |dy| (reference utils.py:154-157)."""
    from scipy import ndimage
    dx = ndimage.sobel(d, 0)
    dy = ndimage.sobel(d, 1)
    return np.abs(dx) + np.abs(dy)


class PointCloudHelper:
    """Unproject a depth map to camera-frame 3D points
    (reference utils.py:160-181)."""

    def __init__(self, width: int = 640, height: int = 480):
        self.xx, self.yy = self.world_coords(width, height)

    @staticmethod
    def world_coords(width: int = 640, height: int = 480):
        hfov_degrees, vfov_degrees = 57, 43
        h_fov = math.radians(hfov_degrees)
        v_fov = math.radians(vfov_degrees)
        cx, cy = width / 2, height / 2
        fx = width / (2 * math.tan(h_fov / 2))
        fy = height / (2 * math.tan(v_fov / 2))
        xx = (np.tile(np.arange(width), height) - cx) / fx
        yy = (np.repeat(np.arange(height), width) - cy) / fy
        return xx, yy

    # reference-name alias
    worldCoords = world_coords

    def depth_to_points(self, depth: np.ndarray) -> np.ndarray:
        """(H, W) depth -> (H*W, 3) points; depth edges > 0.3 become NaN.
        Mutates `depth` in place, as the reference does."""
        depth[edges(depth) > 0.3] = np.nan
        length = depth.shape[0] * depth.shape[1]
        z = depth.reshape(length)
        return np.dstack((self.xx * z, self.yy * z, z)).reshape((length, 3))
