"""BatchNorm with flax's running-variance update.

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
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
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
