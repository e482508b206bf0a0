"""What the offline networks share: norms that compute in float32 and cast
back, the two compute-dtype switches, seeded initialisation and the checked
state_dict load.

The JAX package builds these networks with `dtype=bfloat16` and float32
norms (`nn.BatchNorm(dtype=float32)` / `nn.LayerNorm(dtype=float32)`,
then `.astype(self.dtype)`: `mde_tpu/offline/hrnet.py:37-40`, `swin.py:126`,
`cascade_rcnn.py:65-69`). Here the convolution and linear weights are cast
to the compute dtype once (`to_compute_dtype`, the same round-to-nearest-
even as flax's cast at use), the norms keep float32 parameters, and the
input of each norm goes to float32 and its output back to the input's dtype.
Autocast would not give these casts: it runs `batch_norm` in the input's
dtype and returns `layer_norm` in float32.

Training keeps float32 weights under the optimizer: `cast_at_use` makes
each convolution and linear layer cast its weight, bias and input to the
compute dtype at every call (flax's `dtype=bfloat16` over float32 params,
`scripts/train_detector.py:75-76`), so the gradients reach float32 masters.
In training mode `BatchNorm2d` normalises with the batch statistics and
moves its running stats by flax's rule (`models/norm.py`: momentum 0.9 in
flax's terms, the biased batch variance), in float32.
"""

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import norm


def at_least_f32(x):
    """bf16 and float16 to float32; float32 and float64 as they are."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


class BatchNorm2d(norm.BatchNorm2d):
    """`models/norm.py`'s BatchNorm (flax's running-stat update in training)
    on a float32 copy of the input, cast back to its dtype. The state_dict
    holds weight, bias, running_mean and running_var: no batch counter, which
    flax does not keep. A file's `num_batches_tracked` is dropped here on
    load (torch's own BatchNorm loader would otherwise add one to a
    state_dict without version metadata)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps, momentum=0.1)
        self.register_buffer("num_batches_tracked", None)

    def forward(self, x):
        return super().forward(at_least_f32(x)).to(x.dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        state_dict.pop(prefix + "num_batches_tracked", None)
        nn.Module._load_from_state_dict(self, state_dict, prefix, *args)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis in float32, flax's default eps 1e-6 (mmdet
    uses torch's 1e-5; the port follows the JAX package)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        return F.layer_norm(at_least_f32(x), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


_WEIGHTED = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def to_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every convolution and linear layer of `module` to `dtype`;
    norms and other parameters (Swin's position-bias tables) stay float32."""
    for m in module.modules():
        if isinstance(m, _WEIGHTED):
            m.to(dtype)
    return module


def _cast_forward(m: nn.Module, x):
    dtype = m.compute_dtype
    w = m.weight.to(dtype)
    b = None if m.bias is None else m.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(m, nn.Linear):
        return F.linear(x, w, b)
    if isinstance(m, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, m.stride, m.padding, m.output_padding, m.groups,
                                  m.dilation)
    return m._conv_forward(x, w, b)


def cast_at_use(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every convolution and linear layer of `module` compute in `dtype`
    from its float32 weights, cast at each call with its input; the weights
    stay float32 for the optimizer."""
    for m in module.modules():
        if isinstance(m, _WEIGHTED):
            m.compute_dtype = dtype
            m.forward = functools.partial(_cast_forward, m)
    return module


def compute_dtype(layer: nn.Module) -> torch.dtype:
    """The dtype a convolution or linear layer computes in."""
    return getattr(layer, "compute_dtype", layer.weight.dtype)


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
    then materialised on the CPU by `seed_`, in eval mode as a loaded
    network is (training calls `.train()`)."""
    with torch.device("meta"):
        module = factory()
    return seed_(module.to_empty(device="cpu"), seed).eval()


def load_checked(module: nn.Module, state_dict: dict, what: str) -> nn.Module:
    """`load_state_dict(assign=True)` that raises naming every missing and
    unexpected key (BatchNorm2d drops a file's batch counters). The module
    may live on the meta device: its tensors become the file's."""
    result = module.load_state_dict(state_dict, strict=False, assign=True)
    missing, unexpected = sorted(result.missing_keys), sorted(result.unexpected_keys)
    if missing or unexpected:
        raise KeyError(f"{what}: {len(missing)} missing keys {missing[:20]}, "
                       f"{len(unexpected)} unexpected keys {unexpected[:20]}")
    return module
