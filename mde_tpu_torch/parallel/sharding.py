"""The tensor-parallel layout of a model's parameters, the port's counterpart
of `mde_tpu/parallel/mesh.py::train_state_sharding` (:64-132), and the
state_dict helpers built on it.

`train_state_sharding(model, grid, tp_mode)` gives, for each parameter that
the model group splits, its state_dict name (the one-process model's) ->
(dim, this rank's indices along dim, a LongTensor). Parameters not named
are replicated, as are all buffers (BatchNorm's running stats); AdamW's
moments follow their parameter (`train/optim.py`, `checkpoint.py`).

* "targeted" (the default, JAX's layer set `_TP_COLUMN` / `_TP_ROW`):
  column-parallel (the output dim, torch's dim 0 of a Linear or a Conv2d)
  `conv_head`, `linear1`, `in_proj` and `conv_out`, row-parallel (the input
  dim, torch's dim 1) `linear2` and `out_proj`, where that dim divides by
  the model size m. Three differences from JAX, each pinned by
  tests/test_torch_port_tp.py:
  - `in_proj` is split by heads: a rank holds the q, k and v rows of its
    H/m heads, three blocks of rows. JAX cuts the packed (128, 384) kernel
    into contiguous thirds of its columns; the function and the gathered
    tensor are the same.
  - the attention pair is split only where the heads divide by m (so each
    rank runs whole heads); with 4 heads and m = 3 the port replicates
    `in_proj` and `out_proj`, where JAX splits `in_proj` (384 / 3).
  - a column-parallel layer's bias is split with its weight's rows. JAX
    replicates every 1-D tensor.
* "all" (`scripts/analyze_tp_hlo.py`'s A/B mode in JAX): every parameter of
  two or more dims is split on the dim JAX splits, the last dim of the flax
  tensor: torch's dim 0 of a Linear or Conv2d weight, dim 1 of the
  positional table, where it divides by m. Every such weight is gathered at
  use (`models/tp.py`), so this mode computes JAX's function with no
  per-layer code.
"""

import re
from collections import OrderedDict

import torch

from .mesh import grid as current_grid
from .tensor import place_and_gather

_TP_COLUMN = ("conv_head", "linear1", "in_proj", "conv_out")
_TP_ROW = ("linear2", "out_proj")
_PARAMETRIZED = re.compile(r"\.parametrizations\.(\w+)\.original$")


def plain_name(name: str) -> str:
    """A parameter's one-process state_dict name: a weight gathered at use
    (`models/tp.py`) is stored as `<module>.parametrizations.<attr>.original`."""
    return _PARAMETRIZED.sub(r".\1", name)


def _layer_keys(name: str) -> list:
    """The path of a parameter as JAX's rule reads it: the packed
    `in_proj_weight` / `in_proj_bias` are flax's `in_proj` kernel / bias."""
    parts = name.split(".")
    if parts[-1].startswith("in_proj_"):
        parts = parts[:-1] + ["in_proj", parts[-1][len("in_proj_"):]]
    return parts


def _split_dims(model, m: int, tp_mode: str) -> dict:
    """{name: (dim, "rows" or "heads")} of the parameters split m ways."""
    if tp_mode not in ("targeted", "all"):
        raise ValueError(f"tp_mode {tp_mode!r}: expected 'targeted' or 'all'")
    out = {}
    if m <= 1:
        return out
    params = dict(model.named_parameters())
    for name, p in params.items():
        if tp_mode == "all":
            dim = 1 if name.endswith("positional_encodings") else 0
            if p.dim() >= 2 and p.shape[dim] % m == 0 and p.shape[dim] >= m:
                out[name] = (dim, "rows")
            continue
        keys = _layer_keys(name)
        if "in_proj" in keys or "out_proj" in keys:
            attn = model.get_submodule(name[:name.rindex("self_attn") + len("self_attn")])
            if attn.num_heads % m:
                continue
        if any(k in _TP_COLUMN for k in keys):
            weight = params[name[:-len("bias")] + "weight"] if name.endswith("bias") else p
            if weight.dim() >= 2 and weight.shape[0] % m == 0:
                out[name] = (0, "heads" if "in_proj" in keys else "rows")
        elif any(k in _TP_ROW for k in keys) and p.dim() == 2 and p.shape[1] % m == 0:
            out[name] = (1, "rows")
    return out


def rank_index(kind: str, size: int, m: int, r: int) -> torch.Tensor:
    """Model rank r's indices along a split dim of `size` entries: a
    contiguous m-th ("rows"), or the rows of its heads in each of the
    packed q, k and v ("heads")."""
    if kind == "heads":
        e = size // 3
        k = e // m
        return torch.cat([torch.arange(base + r * k, base + (r + 1) * k)
                          for base in (0, e, 2 * e)])
    k = size // m
    return torch.arange(r * k, (r + 1) * k)


def train_state_sharding(model, grid, tp_mode: str = "targeted") -> dict:
    """{state_dict name: (dim, this rank's LongTensor of indices)} of the
    parameters of the one-process `model` that `grid`'s model group splits
    (module docstring); empty with one model rank."""
    params = dict(model.named_parameters())
    return {name: (dim, rank_index(kind, params[name].shape[dim], grid.model, grid.model_index))
            for name, (dim, kind) in _split_dims(model, grid.model, tp_mode).items()}


def local_state_dict(model) -> OrderedDict:
    """`model.state_dict()` under the one-process names, this rank's slices."""
    return OrderedDict((plain_name(k), v) for k, v in model.state_dict().items())


def shard_state_dict(state_dict: dict, layout: dict) -> OrderedDict:
    """A one-process state_dict cut to this rank's slices."""
    return OrderedDict((k, v.index_select(layout[k][0], layout[k][1].to(v.device))
                        if k in layout else v) for k, v in state_dict.items())


def gather_state_dict(state_dict: dict, layout: dict) -> OrderedDict:
    """The one-process tensors of this rank's slices: a collective of the
    model group, which every rank of it calls with its own slices."""
    out = OrderedDict()
    for k, v in state_dict.items():
        if k in layout:
            dim, index = layout[k]
            v = place_and_gather(v.detach(), dim, index, v.shape[dim] * current_grid().model)
        out[k] = v
    return out


def load_local_state_dict(model, state_dict: dict):
    """Load this rank's slices (one-process names) into a sharded `model`."""
    model.load_state_dict(OrderedDict((k, state_dict[plain_name(k)])
                                      for k in model.state_dict()), strict=True)
    return model
