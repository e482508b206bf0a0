"""Kernels (kernels/chamfer.py -> csrc/chamfer.cu, up to 256 bins): the
chamfer reductions' least time from the bins and each traced step's valid
pixels, over the kernel's device time by name."""

from benchmark.reference import work

KERNELS = ("chamfer_kernel",)


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    us = ctx["trace"].kernel_us(*KERNELS)
    if us <= 0:
        return None
    least = sum(work.chamfer_s(ctx["n_bins"], valid, ctx["depth_pixels"], ctx["images"])
                for valid in ctx["valid_pixels"])
    return 100.0 * least / (us / 1e6)
