"""Step layer (train/loop.py::make_train_step): the model's operations of a
forward and backward an image (torch's flop counter on the plain
reference's shapes), times the untraced window's images a second, over the
cards' bf16 peak (float32 peak for a float32 configuration)."""

from benchmark.reference import work


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    peak = work.BF16_FLOPS if ctx["bf16"] else work.F32_FLOPS
    rate = ctx["window"]["metrics"]["train_img_per_s"]
    return 100.0 * ctx["flops_per_image"] * rate / (peak * ctx["chips"])
