from .bins import bin_edges_from_widths, bin_centers, depth_from_bins
from .losses import bins_chamfer_loss, silog_loss
from .metrics import METRIC_NAMES, compute_errors, compute_errors_masked, eval_mask
from .resize import resize_bilinear_align_corners, resize_nearest

__all__ = ["bin_edges_from_widths", "bin_centers", "depth_from_bins",
           "resize_bilinear_align_corners", "resize_nearest", "silog_loss", "bins_chamfer_loss",
           "METRIC_NAMES", "compute_errors", "compute_errors_masked", "eval_mask"]
