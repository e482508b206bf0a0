"""Model layer (models/): device ms a training step of the kernels launched
inside the harness's span around the model's forward."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["trace"].spans["model.forward"] / 1e3 / ctx["steps"]
