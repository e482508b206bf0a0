"""What the offline networks share: inference-only norms that compute in
float32 and cast back, the compute-dtype switch, seeded initialisation
and the checked state_dict load.

The JAX package builds these networks with `dtype=bfloat16` and float32
norms (`nn.BatchNorm(dtype=float32)` / `nn.LayerNorm(dtype=float32)`,
then `.astype(self.dtype)`: `mde_tpu/offline/hrnet.py:37-40`, `swin.py:126`,
`cascade_rcnn.py:65-69`). Here the convolution and linear weights are cast
to the compute dtype once (`to_compute_dtype`, the same round-to-nearest-
even as flax's cast at use), the norms keep float32 parameters, and the
input of each norm goes to float32 and its output back to the input's dtype.
Autocast would not give these casts: it runs `batch_norm` in the input's
dtype and returns `layer_norm` in float32.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# keys a published checkpoint holds that carry no weight of these networks
IGNORED_KEYS = ("num_batches_tracked",)


class BatchNorm2d(nn.Module):
    """Inference BatchNorm with torch's state_dict names (weight, bias,
    running_mean, running_var), in float32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        y = F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                         self.bias, False, 0.0, self.eps)
        return y.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis in float32, flax's default eps 1e-6 (mmdet
    uses torch's 1e-5; the port follows the JAX package)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


_WEIGHTED = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def to_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every convolution and linear layer of `module` to `dtype`;
    norms and other parameters (Swin's position-bias tables) stay float32."""
    for m in module.modules():
        if isinstance(m, _WEIGHTED):
            m.to(dtype)
    return module


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return math.prod(w.shape[1:])


def _truncated_normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """N(0, std) truncated at two standard deviations, by redrawing."""
    x = torch.randn(shape, generator=gen)
    flat = x.view(-1)
    redraw = (flat.abs() > 2.0).nonzero().squeeze(1)
    while redraw.numel():
        draw = torch.randn(redraw.numel(), generator=gen)
        flat[redraw] = draw
        redraw = redraw[draw.abs() > 2.0]
    return x.mul_(std)


@torch.no_grad()
def seed_(module: nn.Module, seed: int) -> nn.Module:
    """flax's default initialisation of every parameter and buffer, drawn
    from `seed` on the CPU: convolution and linear weights LeCun
    normal (truncated at two standard deviations), their biases zero, norms
    the identity (BatchNorm stats mean 0, variance 1), Swin's position-bias
    tables N(0, 0.02) (`mde_tpu/offline/swin.py:101`). A tensor it does not
    know raises."""
    gen = torch.Generator().manual_seed(seed)
    done = set()

    def put(t, value):
        t.copy_(value if torch.is_tensor(value) else torch.full_like(t, value))
        done.add(id(t))

    for m in module.modules():
        if isinstance(m, _WEIGHTED):
            std = 1.0 / math.sqrt(_fan_in(m)) / 0.87962566103423978
            put(m.weight, _truncated_normal(gen, tuple(m.weight.shape), std))
            if m.bias is not None:
                put(m.bias, 0.0)
        elif isinstance(m, (BatchNorm2d, LayerNorm)):
            put(m.weight, 1.0)
            put(m.bias, 0.0)
            if isinstance(m, BatchNorm2d):
                put(m.running_mean, 0.0)
                put(m.running_var, 1.0)
        table = getattr(m, "relative_position_bias_table", None)
        if isinstance(table, nn.Parameter):
            put(table, torch.randn(tuple(table.shape), generator=gen) * 0.02)
    left = [k for k, t in module.state_dict(keep_vars=True).items() if id(t) not in done]
    if left:
        raise KeyError(f"seed_ does not know {left[:10]}")
    return module


def seeded(factory, seed: int) -> nn.Module:
    """`factory()` built on the meta device (no default initialisation),
    then materialised on the CPU by `seed_`."""
    with torch.device("meta"):
        module = factory()
    return seed_(module.to_empty(device="cpu"), seed)


def load_checked(module: nn.Module, state_dict: dict, what: str) -> nn.Module:
    """`load_state_dict(strict=True, assign=True)` that names every missing
    and unexpected key; `num_batches_tracked` counters are dropped first. The
    module may live on the meta device: its tensors become the file's."""
    sd = {k: v for k, v in state_dict.items() if k.rsplit(".", 1)[-1] not in IGNORED_KEYS}
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"{what}: {len(missing)} missing keys {missing[:20]}, "
                       f"{len(unexpected)} unexpected keys {unexpected[:20]}")
    module.load_state_dict(sd, strict=True, assign=True)
    return module
