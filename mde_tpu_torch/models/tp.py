"""Tensor parallelism over the model group: `shard_model` turns a built,
loaded one-process model into this rank's tensor-parallel model, the port's
counterpart of `jax.device_put(state, train_state_sharding(state, mesh))`
(`mde_tpu/train/driver.py:117-120`), where GSPMD then partitions the step.

The layout is `parallel/sharding.py::train_state_sharding`'s. Each split
parameter keeps this rank's slice only, and the model computes the
one-process function:

* "targeted": Megatron-style column/row pairs, each rank computing its
  slice. The mViT attention runs this rank's heads (`in_proj` column,
  `out_proj` row) and the FFN its slice (`linear1` column, `linear2` row),
  each closed by one sum over the model group (models/mvit.py);
  `conv_head` is column-parallel and its output gathered
  (models/efficientnet.py); `conv_out`'s weight and bias are gathered at
  use, so the bins head runs whole on every rank (models/unet_adaptive_bins.py).
* "all": every split weight is gathered at use.

A weight gathered at use is a torch parametrization: its stored tensor, the
slice, is named `<module>.parametrizations.<attr>.original`
(`parallel.plain_name` gives the one-process name), and each read of
`<module>.<attr>` gathers it (`parallel.gather_from_model`, whose backward
takes this rank's slice of the gradient).
"""

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from ..parallel import gather_from_model, grid as current_grid, train_state_sharding


class _GatherAtUse(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, local):
        return gather_from_model(local, self.dim)


def _gather_at_use(model, name, dim):
    module_name, attr = name.rsplit(".", 1)
    parametrize.register_parametrization(model.get_submodule(module_name), attr,
                                         _GatherAtUse(dim), unsafe=True)


def shard_model(model: nn.Module, grid=None, tp_mode: str = "targeted") -> nn.Module:
    """Cut `model`'s split parameters to this rank's slices (`grid`, the
    process's `parallel.grid()` by default) and set its layers to compute
    them, in place; `model.tp_layout` keeps the layout. With one model rank
    the model is left as it is."""
    grid = current_grid() if grid is None else grid
    layout = train_state_sharding(model, grid, tp_mode)
    model.tp_layout = layout
    if not layout:
        return model
    with torch.no_grad():
        for name, (dim, index) in layout.items():
            p = model.get_parameter(name)
            p.data = p.data.index_select(dim, index.to(p.device))
    if tp_mode == "all":
        for name, (dim, _) in layout.items():
            _gather_at_use(model, name, dim)
        return model
    for module_name, module in model.named_modules():
        prefix = f"{module_name}." if module_name else ""
        if (f"{prefix}in_proj_weight" in layout or f"{prefix}linear1.weight" in layout
                or f"{prefix}conv_head.weight" in layout):
            module.tp = grid
    for name in ("conv_out.0.weight", "conv_out.0.bias"):
        if name in layout:
            _gather_at_use(model, name, 0)
    return model
