"""A faster float64 depthwise convolution for the port's float64 reference
steps (CPU tests only; imports no JAX).

torch's CPU float64 convolution with groups runs one `_slow_conv2d` per
group: a B1 step in float64 makes ~13,700 such calls forward and backward,
most of its time. Inside `depthwise_as_taps()` a float64 `F.conv2d` whose
groups equal its input and output channels (a depthwise convolution) is the
sum of its kh x kw strided, shifted products instead: the same float64
function, its kh x kw terms added in another order (a rounding of 1e-16
relative). Every other convolution goes to torch as before.
"""

import contextlib

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair


def _depthwise(x, weight, bias, stride, padding, dilation):
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    kh, kw = weight.shape[-2:]
    x = F.pad(x, (pw, pw, ph, ph))
    oh = (x.shape[-2] - dh * (kh - 1) - 1) // sh + 1
    ow = (x.shape[-1] - dw * (kw - 1) - 1) // sw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            tap = x[..., i * dh:i * dh + sh * (oh - 1) + 1:sh, j * dw:j * dw + sw * (ow - 1) + 1:sw]
            term = tap * weight[:, 0, i, j].view(1, -1, 1, 1)
            out = term if out is None else out + term
    return out if bias is None else out + bias.view(1, -1, 1, 1)


@contextlib.contextmanager
def depthwise_as_taps():
    """float64 depthwise `F.conv2d` calls as tap sums while the context is
    open (module docstring)."""
    real = F.conv2d

    def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        if (x.dtype == torch.float64 and groups > 1 and x.shape[-3] == groups
                and weight.shape[:2] == (groups, 1) and not isinstance(padding, str)):
            return _depthwise(x, weight, bias, stride, padding, dilation)
        return real(x, weight, bias, stride, padding, dilation, groups)

    F.conv2d = conv2d
    try:
        yield
    finally:
        F.conv2d = real
