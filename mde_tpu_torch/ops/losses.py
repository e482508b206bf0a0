"""Training losses, port of `mde_tpu/ops/losses.py` (reference loss.py:7-46),
NCHW.

* SILog keeps the dense map and weights it by the mask, as the JAX package
  does, instead of gathering the masked pixels.
* `bins_chamfer_loss` is the chunked exact 1-D chamfer between bin centres
  and valid GT depths. It is the plain version of the chamfer kernel
  (kernels/chamfer.py) and differentiates through torch's autograd.
"""

import torch

from .bins import bin_centers
from .resize import resize_bilinear_align_corners


def silog_loss(pred: torch.Tensor, target: torch.Tensor, mask=None,
               interpolate: bool = True) -> torch.Tensor:
    """Scale-invariant log loss, variance form (reference loss.py:12-25).

    Dg = Var_unbiased(g) + 0.15 * mean(g)^2 with g = log(pred) - log(target)
    over masked pixels; loss = 10 * sqrt(Dg). pred and target are
    (N, 1, H, W); with `interpolate` pred is first resized to target's size
    (bilinear, align_corners=True).
    """
    if interpolate:
        pred = resize_bilinear_align_corners(pred, target.shape[-2:])
    g = torch.log(pred.float()) - torch.log(target.float())
    if mask is None:
        m = torch.ones_like(g)
    else:
        m = mask.float()
        g = torch.where(mask, g, torch.zeros_like(g))
    n = m.sum()
    mean = (g * m).sum() / n
    var = (m * (g - mean) ** 2).sum() / torch.clamp(n - 1.0, min=1.0)
    dg = var + 0.15 * mean ** 2
    return 10.0 * torch.sqrt(dg)


def bins_chamfer_loss(bin_edges: torch.Tensor, target_depth: torch.Tensor,
                      valid_threshold: float = 1e-3, chunk: int = 8192) -> torch.Tensor:
    """Chamfer distance between bin centres and valid GT depths.

    Per image, cham_x = mean over bins of the min over valid depths of
    (b - d)^2, cham_y = mean over valid depths of the min over bins;
    loss = mean_i cham_x + mean_i cham_y. Valid depths are target >= 1e-3.
    An image with no valid depth adds 0. The (pixels x bins) distances are
    formed `chunk` pixels at a time.
    """
    centers = bin_centers(bin_edges.float())                          # (N, P)
    n = centers.shape[0]
    d = target_depth.float().reshape(n, -1)                           # (N, M)
    valid = d >= valid_threshold
    big = torch.finfo(torch.float32).max

    min_per_bin = torch.full_like(centers, big)
    sum_y = centers.new_zeros(n)
    for start in range(0, d.shape[1], chunk):
        dc, vc = d[:, start:start + chunk], valid[:, start:start + chunk]
        d2 = (dc[:, :, None] - centers[:, None, :]) ** 2              # (N, K, P)
        sum_y = sum_y + (d2.amin(dim=2) * vc.float()).sum(dim=1)
        masked = torch.where(vc[:, :, None], d2, torch.full_like(d2, big))
        min_per_bin = torch.minimum(min_per_bin, masked.amin(dim=1))

    counts = valid.float().sum(dim=1)
    has_valid = counts > 0
    zero = torch.zeros_like(min_per_bin)
    cham_x = torch.where(min_per_bin >= big, zero, min_per_bin).mean(dim=1)
    cham_y = sum_y / torch.clamp(counts, min=1.0)
    cham_x = torch.where(has_valid, cham_x, torch.zeros_like(cham_x))
    cham_y = torch.where(has_valid, cham_y, torch.zeros_like(cham_y))
    return cham_x.mean() + cham_y.mean()
