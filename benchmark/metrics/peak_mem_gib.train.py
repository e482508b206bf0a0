"""Device memory: torch's max_memory_allocated over the untraced window of
training steps, after a reset at its start, in GiB."""


def read(ctx):
    if ctx.get("kind") != "train" or ctx["device"] != "cuda":
        return None
    return ctx["window_peak_bytes"] / 2 ** 30
