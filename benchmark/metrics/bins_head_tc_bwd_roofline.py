"""Kernels (kernels/bins_head.py -> csrc/bins_head_tc.cu): the bf16 head
backward's least time (its pixel and weight kernels together) at the step's
shapes over their device time by name."""

from benchmark.reference import work

KERNELS = ("bins_head_tc_bwd_pixel_kernel", "bins_head_tc_bwd_weight_kernel")


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["bf16"]:
        return None
    us = ctx["trace"].kernel_us(*KERNELS)
    if us <= 0:
        return None
    least = work.head_bwd_s(ctx["head_pixels"], ctx["n_bins"], True) * ctx["steps"]
    return 100.0 * least / (us / 1e6)
