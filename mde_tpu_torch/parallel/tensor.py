"""The model group's collectives as autograd functions (Megatron-LM's f and g
operators), for the tensor-parallel layers of `models/tp.py`.

* `copy_to_model(x)`: identity forward; the backward sums the gradient over
  the model group. It stands before a column-parallel layer, whose input is
  replicated and whose every rank hands back only its slice's share of
  d/dx.
* `reduce_from_model(x)`: the forward sums over the model group; identity
  backward. It closes a row-parallel layer, whose ranks each hold a partial
  sum; its output is replicated, so every rank's gradient is already the
  whole one. (`torch.distributed.nn.functional.all_reduce`, which
  `parallel/mesh.py::all_reduce_sum` uses for the data group, also sums in
  its backward: here that would hand every rank m times its gradient.)
* `gather_from_model(x, dim)`: the forward concatenates the ranks' equal
  slices along `dim`, rank order; the backward takes this rank's slice. Its
  output feeds replicated work, whose gradient is the same on every rank.
  The gather is an all-reduce of a zero-filled full tensor that holds this
  rank's slice: exact (each element is one rank's value plus zeros), and
  one collective that NCCL and gloo both run on CUDA tensors (torch's
  backend table lists gloo's all_gather as CPU-only).

Each is the identity without a model group (one model rank).
"""

import torch
import torch.distributed as dist

from .mesh import grid, model_group


def _all_reduce(t):
    t = t.contiguous().clone()
    dist.all_reduce(t, group=model_group())
    return t


def place_and_gather(x: torch.Tensor, dim: int, index: torch.Tensor, size: int) -> torch.Tensor:
    """The full tensor of `size` entries along `dim`, each rank's slice `x`
    at its own positions `index` (LongTensor), summed over the model group:
    every rank gets the whole tensor."""
    shape = list(x.shape)
    shape[dim] = size
    full = x.new_zeros(shape).index_copy_(dim, index.to(x.device), x)
    dist.all_reduce(full, group=model_group())
    return full


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        g = grid()
        ctx.dim, ctx.size, ctx.start = dim, x.shape[dim], g.model_index * x.shape[dim]
        index = torch.arange(ctx.start, ctx.start + ctx.size, device=x.device)
        return place_and_gather(x, dim, index, ctx.size * g.model)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.size).contiguous(), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return x if model_group() is None else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return x if model_group() is None else _ReduceFromModel.apply(x)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x if model_group() is None else _GatherFromModel.apply(x, dim)
