"""BatchNorm with flax's running-variance update, over the global batch.

In training mode flax `nn.BatchNorm` and `torch.nn.BatchNorm2d` both
normalise with the batch mean and the biased batch variance, but torch moves
`running_var` towards the *unbiased* variance (times n / (n - 1), n the
values per channel) and flax towards the biased one. The JAX package is the
reference, so this subclass runs torch's fused kernel and then replaces the
variance term of its update:

    torch: rv = (1 - m) rv_old + m var n / (n - 1)
    flax:  rv = (1 - m) rv_old + m var
           = (1 - m) rv_old + (rv_torch - (1 - m) rv_old) (n - 1) / n

a few per-channel ops, with no second pass over the activations. Parameter
and buffer names are torch's, so state_dicts load as they are.

Two more cases in training mode:

* **Several ranks** (`parallel.sync_group()` set): the JAX step's batch
  statistics are those of the global batch, so the per-channel sums (taken
  about the running mean, which every rank holds alike, to keep the float32
  variance from cancelling) are summed over the ranks by a differentiable
  all-reduce in float32, and the batch is normalised with the global mean
  and biased variance; the running stats move by flax's rule once.
  `torch.nn.SyncBatchNorm` would move `running_var` to the unbiased
  variance, and refuses CPU tensors.
* **Recomputation** (`--remat encoder`, `recomputation()`): a checkpointed
  block runs its forward a second time in the backward. That pass gives the
  same output by the same kernel (and, with several ranks, the same
  collectives) but updates copies of the running stats, so they move once,
  as under flax's `nn.remat`.
"""

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import all_reduce_sum, sync_group

_RECOMPUTING = 0


@contextlib.contextmanager
def recomputation():
    """Marks a checkpointed block's second forward: BatchNorms leave their
    running stats as they are."""
    global _RECOMPUTING
    _RECOMPUTING += 1
    try:
        yield
    finally:
        _RECOMPUTING -= 1


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        update = not _RECOMPUTING
        if sync_group() is not None:
            return self._global_forward(x, update)
        if not update:
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        # torch updates (and autograd keeps) a copy; the buffer gets flax's value
        torch_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, torch_var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            old = self.running_var
            keep = 1.0 - self.momentum
            old.copy_(keep * old + (torch_var - keep * old) * ((n - 1) / n))
        return y

    def _global_forward(self, x, update):
        c = x.shape[1]
        shape = (1, c, 1, 1)
        xf = x.float()
        shift = self.running_mean.detach().view(shape)
        d = xf - shift
        count = torch.full((1,), float(x.numel() // c), device=x.device)
        sums = all_reduce_sum(torch.cat([d.sum((0, 2, 3)), (d * d).sum((0, 2, 3)), count]))
        n = sums[-1]
        m1, m2 = sums[:c] / n, sums[c:2 * c] / n
        var = torch.clamp(m2 - m1 * m1, min=0.0)
        mean = shift.view(c) + m1
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        if update:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(keep * self.running_var + self.momentum * var)
        return y.to(x.dtype)
