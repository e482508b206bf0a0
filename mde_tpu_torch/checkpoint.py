"""Weights and checkpoints for the port, counterpart of `mde_tpu/checkpoint.py`.

`save_checkpoint` / `load_checkpoint` (`mde_tpu/checkpoint.py:37, :63`) write
and read a training checkpoint in the reference layout (model_io.py:15-26):
`torch.save` of {"model": state_dict, "optimizer": the AdamW state_dict,
"epoch": epoch}, so `mde_tpu.checkpoint.convert_reference_checkpoint` reads a
port checkpoint as it reads an AdaBins .pt file. One key more, "step" (the
updates taken, which the OneCycle schedule is evaluated at), lets a resumed
run continue its schedule; the converter ignores it. Under tensor
parallelism (`model.tp_layout`, models/tp.py) the file holds the gathered
tensors and AdamW moments, the same file one process writes: saving is a
collective of the model group, and global rank 0 writes; loading cuts the
file to the rank's slices, under any grid.

`state_dict_from_flax` turns the JAX package's (params, batch_stats) trees,
as numpy arrays, into a port state_dict under the reference's torch names; it
is the inverse of `mde_tpu.checkpoint.convert_reference_checkpoint` and
`convert_backbone_statedict`. `load_reference_checkpoint` loads a reference
AdaBins .pt file into a port model.

Backbone files for `--pretrained_backbone` (`mde_tpu/checkpoint.py:248-277`)
keep the flax-tree layout, so one .npz serves both packages:
`save_backbone_npz` / `load_backbone_npz` flatten and rebuild the encoder's
(params, batch_stats) trees; `backbone_trees` makes them from a
gen-efficientnet state_dict (the port's copy of `convert_backbone_statedict`)
and `backbone_state_dict` turns them back into the encoder's state_dict.

The JAX package's orbax checkpoints are read by the root script
`orbax_to_pt.py`, which needs JAX and writes this module's layout.
"""

import os
from collections import OrderedDict

import numpy as np
import torch

from .models.efficientnet import _B0_STAGES, EFFICIENTNET_CONFIGS, round_repeats
from .parallel import (gather_state_dict, load_local_state_dict, local_state_dict,
                       shard_state_dict, world)


def _strip_prefixes(sd: dict) -> dict:
    """DDP `module.` strip + legacy mViT renames (reference model_io.py:44-69)."""
    out = OrderedDict()
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        k = k.replace("adaptive_bins_layer.embedding_conv.",
                      "adaptive_bins_layer.conv3x3.")
        k = k.replace("adaptive_bins_layer.patch_transformer.embedding_encoder",
                      "adaptive_bins_layer.patch_transformer.embedding_convPxP")
        out[k] = v
    return out


def _moments(optimizer_state: dict, names: list, layout: dict, cut) -> dict:
    """The AdamW state_dict with each split parameter's moments through
    `cut(tensor, name)`."""
    state = {i: {k: cut(v, names[i]) if k.startswith("exp_avg") and names[i] in layout else v
                 for k, v in s.items()} for i, s in optimizer_state["state"].items()}
    return {**optimizer_state, "state": state}


def save_checkpoint(state, epoch: int, filename: str, root: str = "./checkpoints") -> str:
    """Write `state` (train/state.py: the model, its optimizer and step) to
    root/filename in the reference layout, through a temporary file renamed
    into place; returns the path. Under tensor parallelism every rank calls
    it (it gathers the slices) and global rank 0 writes."""
    layout = getattr(state.model, "tp_layout", None) or {}
    model_sd = state.model.state_dict()
    optimizer_sd = state.optimizer.optimizer.state_dict()
    if layout:
        model_sd = gather_state_dict(local_state_dict(state.model), layout)
        optimizer_sd = _moments(optimizer_sd, state.optimizer.names, layout,
                                lambda t, name: gather_state_dict({name: t}, layout)[name])
    path = os.path.abspath(os.path.join(root, filename))
    if world()[0] != 0:
        return path
    os.makedirs(root, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": model_sd, "optimizer": optimizer_sd,
                "epoch": int(epoch), "step": int(state.step)}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state):
    """Restore a `save_checkpoint` file into `state` (its model, optimizer
    and step), on the model's device, cut to the rank's slices under tensor
    parallelism; returns (state, epoch)."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model_sd, optimizer_sd = _strip_prefixes(ckpt["model"]), ckpt["optimizer"]
    layout = getattr(state.model, "tp_layout", None) or {}
    if layout:
        load_local_state_dict(state.model, shard_state_dict(model_sd, layout))
        optimizer_sd = _moments(optimizer_sd, state.optimizer.names, layout,
                                lambda t, name: shard_state_dict({name: t}, layout)[name])
    else:
        state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.optimizer.load_state_dict(optimizer_sd)
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"])


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference .pt file ({'model': state_dict, ...} or a bare
    state_dict) into `model` with strict=True."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    model.load_state_dict(_strip_prefixes(sd), strict=True)
    return model


class _Writer:
    """Collects torch tensors from flax leaves under torch names."""

    def __init__(self):
        self.sd = OrderedDict()

    def put(self, name, array):
        self.sd[name] = torch.from_numpy(np.array(array, dtype=np.float32))

    def conv(self, name, p):
        """flax HWIO kernel (+bias) -> torch OIHW weight (+bias); depthwise
        (H, W, 1, C) maps to (C, 1, H, W) by the same transpose."""
        self.put(name + ".weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self.put(name + ".bias", p["bias"])

    def dense(self, name, p):
        self.put(name + ".weight", np.asarray(p["kernel"]).T)
        self.put(name + ".bias", p["bias"])

    def norm(self, name, p):
        self.put(name + ".weight", p["scale"])
        self.put(name + ".bias", p["bias"])

    def bn(self, name, p, st):
        self.norm(name, p)
        self.put(name + ".running_mean", st["mean"])
        self.put(name + ".running_var", st["var"])
        self.sd[name + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _encoder(wr, prefix, params, stats, arch):
    """Block members keep their names across the two trees (conv_dw, bn1,
    se, conv_pw, ...); only the block path differs."""
    _, depth = EFFICIENTNET_CONFIGS[arch]
    wr.conv(prefix + "conv_stem", params["conv_stem"])
    wr.bn(prefix + "bn1", params["bn1"], stats["bn1"])
    for stage_i, (_e, _k, _s, _c, base_r) in enumerate(_B0_STAGES):
        for rep in range(round_repeats(base_r, depth)):
            p, st = params[f"blocks_{stage_i}_{rep}"], stats[f"blocks_{stage_i}_{rep}"]
            dst = f"{prefix}blocks.{stage_i}.{rep}."
            for name, sub in p.items():
                if name == "se":
                    wr.conv(dst + "se.conv_reduce", sub["conv_reduce"])
                    wr.conv(dst + "se.conv_expand", sub["conv_expand"])
                elif name.startswith("bn"):
                    wr.bn(dst + name, sub, st[name])
                else:
                    wr.conv(dst + name, sub)
    wr.conv(prefix + "conv_head", params["conv_head"])
    wr.bn(prefix + "bn2", params["bn2"], stats["bn2"])


def backbone_state_dict(params: dict, stats: dict, arch: str) -> OrderedDict:
    """The encoder's flax (params, batch_stats) trees -> the state_dict of
    `EfficientNetEncoder` (gen-efficientnet names, no prefix)."""
    wr = _Writer()
    _encoder(wr, "", params, stats, arch)
    return wr.sd


def _np(t):
    return t.detach().cpu().numpy()


def backbone_trees(sd: dict, arch: str):
    """gen-efficientnet tf_efficientnet_{b1,b5}_ap state_dict (bare, or under
    `encoder.original_model.`) -> the encoder's flax (params, batch_stats)
    trees of numpy arrays; the port's copy of
    `mde_tpu.checkpoint.convert_backbone_statedict`."""
    prefix = "encoder.original_model."
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}

    def conv(name):
        p = {"kernel": _np(sd[name + ".weight"]).transpose(2, 3, 1, 0)}
        if name + ".bias" in sd:
            p["bias"] = _np(sd[name + ".bias"])
        return p

    def bn(name):
        return ({"scale": _np(sd[name + ".weight"]), "bias": _np(sd[name + ".bias"])},
                {"mean": _np(sd[name + ".running_mean"]), "var": _np(sd[name + ".running_var"])})

    _, depth = EFFICIENTNET_CONFIGS[arch]
    params, stats = {"conv_stem": conv("conv_stem")}, {}
    params["bn1"], stats["bn1"] = bn("bn1")
    for stage_i, (expand, _k, _s, _c, base_r) in enumerate(_B0_STAGES):
        for rep in range(round_repeats(base_r, depth)):
            src, p, st = f"blocks.{stage_i}.{rep}", {}, {}
            names = (("conv_dw", "bn1", "se", "conv_pw", "bn2") if expand == 1 else
                     ("conv_pw", "bn1", "conv_dw", "bn2", "se", "conv_pwl", "bn3"))
            for name in names:
                if name == "se":
                    p["se"] = {"conv_reduce": conv(src + ".se.conv_reduce"),
                               "conv_expand": conv(src + ".se.conv_expand")}
                elif name.startswith("bn"):
                    p[name], st[name] = bn(f"{src}.{name}")
                else:
                    p[name] = conv(f"{src}.{name}")
            params[f"blocks_{stage_i}_{rep}"], stats[f"blocks_{stage_i}_{rep}"] = p, st
    params["conv_head"] = conv("conv_head")
    params["bn2"], stats["bn2"] = bn("bn2")
    return params, stats


def save_backbone_npz(params: dict, stats: dict, out_path: str) -> None:
    """Flatten backbone trees into an .npz for --pretrained_backbone
    (`mde_tpu/checkpoint.py:248-262`: `params:a/b/c` and `stats:a/b/c` keys)."""
    flat = {}

    def walk(tree, prefix, bucket):
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, key + "/", bucket)
            else:
                flat[f"{bucket}:{key}"] = np.asarray(v)

    walk(params, "", "params")
    walk(stats, "", "stats")
    np.savez_compressed(out_path, **flat)


def load_backbone_npz(path: str):
    """Inverse of save_backbone_npz: .npz -> (params, stats) nested trees."""
    params, stats = {}, {}
    with np.load(path) as data:
        for key in data.files:
            bucket, rest = key.split(":", 1)
            node = params if bucket == "params" else stats
            parts = rest.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return params, stats


_CUE_MLPS = ("semantics_areas_fc", "semantics_absolute_sizes_fc", "instance_areas_fc",
             "instance_absolute_sizes_fc")


def state_dict_from_flax(params: dict, batch_stats: dict,
                         encoder_name: str = "efficientnet-b1") -> OrderedDict:
    """JAX UnetAdaptiveBins (params, batch_stats) trees of numpy arrays ->
    port state_dict under the reference's torch names: the CueMLPs the tree
    holds, and the AdaBins head unless the tree has none (noAdaBins). The
    widths (a stem or an mViT widened by cues) come with the arrays."""
    arch = "efficientnet-b5" if "efficientnet-b5" in encoder_name else "efficientnet-b1"
    wr = _Writer()
    _encoder(wr, "encoder.original_model.", params["encoder"], batch_stats["encoder"],
             arch)

    dp, dst = params["decoder"], batch_stats["decoder"]
    wr.conv("decoder.conv2", dp["conv2"])
    for i in range(1, 5):
        up, ust = dp[f"up{i}"], dst[f"up{i}"]
        wr.conv(f"decoder.up{i}._net.0", up["conv_a"])
        wr.bn(f"decoder.up{i}._net.1", up["bn_a"], ust["bn_a"])
        wr.conv(f"decoder.up{i}._net.3", up["conv_b"])
        wr.bn(f"decoder.up{i}._net.4", up["bn_b"], ust["bn_b"])
    wr.conv("decoder.conv3", dp["conv3"])
    for name in _CUE_MLPS:
        if name in params:
            wr.conv(name + ".0", params[name]["fc0"])
            wr.conv(name + ".2", params[name]["fc1"])
    if "adaptive_bins_layer" not in params:
        return wr.sd

    ab = params["adaptive_bins_layer"]
    pt = ab["patch_transformer"]
    root = "adaptive_bins_layer.patch_transformer."
    wr.conv(root + "embedding_convPxP", pt["embedding_convPxP"])
    wr.put(root + "positional_encodings", pt["positional_encodings"])
    for i in range(4):
        layer = pt[f"layer_{i}"]
        dst_l = f"{root}transformer_encoder.layers.{i}."
        attn = layer["self_attn"]
        wr.put(dst_l + "self_attn.in_proj_weight", np.asarray(attn["in_proj"]["kernel"]).T)
        wr.put(dst_l + "self_attn.in_proj_bias", attn["in_proj"]["bias"])
        wr.dense(dst_l + "self_attn.out_proj", attn["out_proj"])
        wr.dense(dst_l + "linear1", layer["linear1"])
        wr.dense(dst_l + "linear2", layer["linear2"])
        wr.norm(dst_l + "norm1", layer["norm1"])
        wr.norm(dst_l + "norm2", layer["norm2"])
    wr.conv("adaptive_bins_layer.conv3x3", ab["conv3x3"])
    for i, src_i in enumerate((0, 2, 4)):
        wr.dense(f"adaptive_bins_layer.regressor.{src_i}", ab[f"regressor_{i}"])
    wr.conv("conv_out.0", params["conv_out"])
    return wr.sd
