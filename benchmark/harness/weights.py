"""Seeded weights, made on the device in a few large calls.

One draw per kind of leaf, split into the leaves of the plain reference's
state_dict in its order, so the program and the reference load the same
dict. Kinds: running means uniform in [-0.1, 0.1), running variances in
[0.5, 1.5), the positional table in [0, 1), kernels normal over the square
root of their fan-in, norm scales 1 + 0.1 N, biases 0.1 N.
"""

import torch


def _kind(name, t):
    if name.endswith("num_batches_tracked"):
        return "count"
    if name.endswith("running_mean"):
        return "mean"
    if name.endswith("running_var"):
        return "var"
    if name.endswith("positional_encodings"):
        return "uniform"
    if t.dim() > 1:
        return "kernel"
    return "scale" if name.endswith("weight") else "bias"


def seeded_state_dict(shapes, seed, device):
    """{name: tensor} for the (name, tensor) pairs `shapes` (a state_dict of
    the plain reference, on any device), float32 but for the counters."""
    gen = torch.Generator(device=device).manual_seed(seed)
    groups = {}
    for name, t in shapes.items():
        groups.setdefault(_kind(name, t), []).append((name, t))
    out = {}
    for kind in ("mean", "var", "uniform", "kernel", "scale", "bias", "count"):
        leaves = groups.get(kind, [])
        if not leaves:
            continue
        sizes = [t.numel() for _, t in leaves]
        if kind == "count":
            flat = torch.zeros(sum(sizes), dtype=torch.long, device=device)
        elif kind in ("mean", "var", "uniform"):
            flat = torch.rand(sum(sizes), generator=gen, device=device)
            flat = {"mean": 0.2 * flat - 0.1, "var": 0.5 + flat, "uniform": flat}[kind]
        else:
            flat = torch.randn(sum(sizes), generator=gen, device=device)
            if kind == "kernel":
                fan_in = torch.tensor([t[0].numel() for _, t in leaves], device=device)
                flat = flat / torch.repeat_interleave(fan_in.float().sqrt(),
                                                      torch.tensor(sizes, device=device))
            else:
                flat = 1.0 + 0.1 * flat if kind == "scale" else 0.1 * flat
        for (name, t), part in zip(leaves, flat.split(sizes)):
            out[name] = part.view(t.shape)
    return out
