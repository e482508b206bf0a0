from .dataset import DepthDataLoader, DepthDataset, collate
from .decode import image_size, read_png, read_rgb
from .prefetch import DevicePrefetcher
from .transforms import normalize_image

__all__ = ["DepthDataLoader", "DepthDataset", "collate", "image_size", "read_png", "read_rgb",
           "DevicePrefetcher", "normalize_image"]
