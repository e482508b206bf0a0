from .bins_head import fused_bins_head, fused_bins_head_reference, fused_head_supported
from .chamfer import chamfer_1d, chamfer_reductions, chamfer_reductions_reference

__all__ = ["fused_bins_head", "fused_bins_head_reference", "fused_head_supported",
           "chamfer_1d", "chamfer_reductions", "chamfer_reductions_reference"]
