"""Optimizer layer (train/optim.py::OneCycleAdamW): device ms a step of the
kernels launched inside the harness's span around the optimizer's step
(the clip and the AdamW update)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["trace"].spans["optimizer.step"] / 1e3 / ctx["steps"]
