"""Cue layer (cues/embedders.py and the CueMLPs of
models/unet_adaptive_bins.py): device ms a step of the kernels launched
inside the harness's spans around the two embedders and the CueMLPs'
forwards. Nothing where the configuration has no cues."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    us = ctx["trace"].spans.get("cues", 0.0)
    return us / 1e3 / ctx["steps"] if us > 0 else None
