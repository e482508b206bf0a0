"""Device (H100): the share of a training step in which no kernel or copy
runs on the card: one minus the device's busy time a step, from the traced
steps, over the untraced window's time a step. The profiler slows the host
(a traced step takes about twice an untraced one), so the traced window's
own idle share measures the profiler; the busy time a step does not change
with it."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    w = ctx["window"]
    busy = ctx["trace"].busy_s / ctx["steps"]
    return 100.0 * (1.0 - busy / (w["seconds"] / w["steps"]))
