#!/usr/bin/env python
"""Convert an orbax checkpoint of the JAX package (`mde_tpu`) into a `.pt`
file of the PyTorch port (`mde_tpu_torch`):

    python orbax_to_pt.py params/args_train_nyu_efficientnet-b1.txt \
        --orbax_dir runs/UnetAdaptiveBins/<name>_<run id>_latest --out latest.pt

The params file (and any overrides after it) describes the model as for
`train.py`: the encoder, the bins, the cues and their insertion point. The
script restores the directory raw, without a template
(`mde_tpu.checkpoint.load_checkpoint`, as `mde_tpu/evaluate.py:129-149`
does), maps `params` and `batch_stats` through the port's
`state_dict_from_flax`, and the AdamW moments and count of the optax chain
(`mde_tpu/train/optim.py::build_optimizer`: clip, then
`inject_hyperparams(adamw)`, whose `ScaleByAdamState` holds `mu`, `nu` and
`count`) into the port's `torch.optim.AdamW` state in the port's parameter
order (`mde_tpu_torch/train/optim.py`). It writes the port's layout
{model, optimizer, epoch, step}, which `InferenceHelper`, `python -m
mde_tpu_torch.evaluate` and `--resume PATH` read. A restored state without
`batch_stats` or without the AdamW moments and count is refused: a resume
from it would continue the schedule at the saved step with zeroed moments.

It imports both packages, so it runs where JAX runs; the port's own machine
needs only the `.pt`.
"""

import sys

import numpy as np
import torch

from mde_tpu.checkpoint import load_checkpoint
from mde_tpu_torch.checkpoint import state_dict_from_flax
from mde_tpu_torch.config import TrainArgParser, parse_cli
from mde_tpu_torch.models import build_model
from mde_tpu_torch.train import create_train_state


def _adam_state(tree):
    """The node of the restored optimizer state that holds mu, nu, count."""
    if isinstance(tree, dict):
        if {"mu", "nu", "count"} <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def _keys(tree) -> list:
    """Every dict key in a restored tree, sorted."""
    if isinstance(tree, dict):
        return sorted({str(k) for k in tree} | {k for v in tree.values() for k in _keys(v)})
    if isinstance(tree, (list, tuple)):
        return sorted({k for v in tree for k in _keys(v)})
    return []


def convert(args, orbax_dir: str) -> dict:
    """The port's checkpoint dict for the orbax directory `orbax_dir`."""
    restored, epoch = load_checkpoint(orbax_dir)
    stats = restored.get("batch_stats")
    adam = _adam_state(restored.get("opt_state"))
    if not stats or adam is None:
        missing = [name for name, ok in (("batch_stats", stats),
                                         ("the AdamW mu, nu and count", adam is not None))
                   if not ok]
        raise ValueError(f"{orbax_dir}: the restored state has no {' and no '.join(missing)} "
                         f"(top-level keys {sorted(restored)}; opt_state keys "
                         f"{_keys(restored.get('opt_state'))})")
    model = build_model(args)
    model.load_state_dict(state_dict_from_flax(restored["params"], stats, args.encoder_name),
                          strict=True)
    state = create_train_state(model, args, steps_per_epoch=1)
    optimizer = state.optimizer.optimizer.state_dict()
    mu = state_dict_from_flax(adam["mu"], stats, args.encoder_name)
    nu = state_dict_from_flax(adam["nu"], stats, args.encoder_name)
    names = {id(p): k for k, p in model.named_parameters()}
    count = torch.tensor(float(np.asarray(adam["count"])))
    ordered = [names[id(p)] for g in state.optimizer.optimizer.param_groups
               for p in g["params"]]
    optimizer["state"] = {i: {"step": count.clone(), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
                          for i, k in enumerate(ordered)}
    return {"model": model.state_dict(), "optimizer": optimizer, "epoch": int(epoch),
            "step": int(np.asarray(restored["step"]))}


def main(argv=None):
    parser = TrainArgParser(description=__doc__.splitlines()[0], fromfile_prefix_chars="@",
                            conflict_handler="resolve")
    parser.add_argument("--orbax_dir", required=True, help="the JAX package's checkpoint")
    parser.add_argument("--out", required=True, help="the .pt file to write")
    args = parse_cli(parser, argv, mode="train")
    ckpt = convert(args, args.orbax_dir)
    torch.save(ckpt, args.out)
    print(f"{args.orbax_dir} -> {args.out}: {len(ckpt['model'])} tensors, "
          f"{len(ckpt['optimizer']['state'])} AdamW states, epoch {ckpt['epoch']}, "
          f"step {ckpt['step']}")


if __name__ == "__main__":
    main(sys.argv[1:])
