"""The one generator of the benchmark's traffic, read from a mix's
parameters (traffic/<mix>.json) and seeded from `--seed`.

Training batches ("pool" batches of "batch" frames of "height" x "width",
made on the device): images N(0, 1) as after the ImageNet normalisation;
depths smooth fields in whole millimetres (NYU's ground truth is stored in
mm), a tilted plane and three low-frequency waves, each frame between its
own near and far depth, at least "depth_span_min_m" apart within
"depth_min_m" and "depth_max_m" (a small room and a long one), with
"invalid_share" of each frame's pixels set to 0 in blobs (where another
smooth field is highest). A configuration with cues
also gets the raw cue maps its loaders give: semantic labels over
"semantic_classes" classes in Voronoi regions, their count drawn from
"semantic_regions"; instance labels over "instance_classes" classes in
Voronoi cells, their count drawn from "instances", as many background
cells (class "instance_background") beside them; instance areas, each
instance pixel holding its cell's pixel count and the background 0.
"""

import math

import numpy as np
import torch


def sub_seed(seed, *keys):
    """An independent 32-bit seed for one stream of `seed`."""
    return int(np.random.SeedSequence([int(seed), *keys]).generate_state(1)[0])


def _grid(h, w, device):
    y = torch.linspace(0.0, 1.0, h, device=device)[:, None].expand(h, w)
    x = torch.linspace(0.0, 1.0, w, device=device)[None, :].expand(h, w)
    return y, x


def _smooth(n, h, w, gen, device, waves=3):
    """(n, h, w) smooth fields in [0, 1]: a tilted plane plus low waves."""
    y, x = _grid(h, w, device)
    r = torch.rand((n, 2 + 4 * waves), generator=gen, device=device)
    field = r[:, 0, None, None] * x + r[:, 1, None, None] * y
    for k in range(waves):
        fy, fx, phase, amp = (r[:, 2 + 4 * k + j, None, None] for j in range(4))
        field = field + 0.5 * amp * torch.sin(2 * math.pi * (3 * fy * y + 3 * fx * x + phase))
    lo = field.flatten(1).amin(1)[:, None, None]
    hi = field.flatten(1).amax(1)[:, None, None]
    return (field - lo) / (hi - lo).clamp(min=1e-6)


def _voronoi(h, w, count, gen, device):
    """(h, w) index of the nearest of `count` random points."""
    y, x = _grid(h, w, device)
    pts = torch.rand((count, 2), generator=gen, device=device)
    d = (y.reshape(-1, 1) - pts[:, 0]) ** 2 + (x.reshape(-1, 1) - pts[:, 1]) ** 2
    return d.argmin(1).reshape(h, w)


def _draw(lo_hi, gen, device):
    lo, hi = lo_hi
    return int(torch.randint(lo, hi + 1, (1,), generator=gen, device=device))


def _cue_maps(n, h, w, t, gen, device):
    sem = torch.empty((n, 1, h, w), dtype=torch.int32, device=device)
    labels = torch.empty((n, 1, h, w), dtype=torch.int32, device=device)
    areas = torch.empty((n, 1, h, w), dtype=torch.float32, device=device)
    for i in range(n):
        k = _draw(t["semantic_regions"], gen, device)
        cls = torch.randint(0, t["semantic_classes"], (k,), generator=gen, device=device)
        sem[i, 0] = cls[_voronoi(h, w, k, gen, device)].int()
        k = _draw(t["instances"], gen, device)
        cell = _voronoi(h, w, 2 * k, gen, device)
        cls = torch.randint(0, t["instance_classes"], (2 * k,), generator=gen, device=device)
        cls[k:] = t["instance_background"]
        count = torch.bincount(cell.reshape(-1), minlength=2 * k).float()
        count[k:] = 0.0
        labels[i, 0] = cls[cell].int()
        areas[i, 0] = count[cell]
    return {"semantics": sem, "instance_labels": labels, "instance_areas": areas}


def train_pool(t, with_cues, seed, device):
    """The pool of training batches, each a dict of device tensors."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    n, h, w = t["batch"], t["height"], t["width"]
    pool = []
    for _ in range(t["pool"]):
        lo, hi, span = t["depth_min_m"], t["depth_max_m"], t["depth_span_min_m"]
        near = lo + (hi - lo - span) * torch.rand((n, 1, 1), generator=gen, device=device)
        far = near + span + (hi - near - span) * torch.rand((n, 1, 1), generator=gen,
                                                            device=device)
        field = near + (far - near) * _smooth(n, h, w, gen, device)
        depth = torch.round(1000.0 * field) / 1000.0
        holes = _smooth(n, h, w, gen, device)
        cut = torch.quantile(holes.flatten(1)[:, ::7], 1.0 - t["invalid_share"], dim=1)
        depth = torch.where(holes > cut[:, None, None], 0.0, depth)
        batch = {"image": torch.randn((n, 3, h, w), generator=gen, device=device),
                 "depth": depth[:, None].contiguous()}
        if with_cues:
            batch.update(_cue_maps(n, h, w, t, gen, device))
        pool.append(batch)
    return pool

