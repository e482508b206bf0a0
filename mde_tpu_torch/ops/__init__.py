from .bins import bin_edges_from_widths, bin_centers, depth_from_bins
from .losses import bins_chamfer_loss, silog_loss
from .resize import resize_bilinear_align_corners, resize_nearest

__all__ = ["bin_edges_from_widths", "bin_centers", "depth_from_bins",
           "resize_bilinear_align_corners", "resize_nearest", "silog_loss", "bins_chamfer_loss"]
