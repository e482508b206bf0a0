"""End-to-end training driver, the port's counterpart of
`mde_tpu/train/driver.py` (reference train.py:264-502).

`main_train(args)` builds the model, the cue embedders and the loaders over
an NYU- or KITTI-format tree, and trains on one device (`args.device`, cuda
unless the caller asks for cpu): batches come through `DevicePrefetcher`,
each step is `make_train_step`'s, and `bookkeep` writes what the JAX driver
writes at its cadence (:164-215): `Train/Loss`, `Train/SILog` and
`Train/ChamferLoss` every 5 steps; at every `validate_every`-th step and at
`max_steps`, a `validate` pass (`Test/SILog`, `Metrics/*`), the latest
checkpoint and, when abs_rel improves, the best; `Epoch` at each epoch's
start. The scalars go to `events.jsonl` in the experiment directory.

`--resume latest` (the newest `*_latest.pt` in the experiment directory) or
`--resume PATH` restores the model, the optimizer and the step, and goes on
from that step: at its epoch, past the batches of that epoch already taken,
with the OneCycle schedule where it stopped.

Not in this slice: the 500-step qualitative figures (`utils/graphs.py`),
`--pretrained_backbone`, DDP (`--distributed` under torchrun raises; without
it the run is one process, as the JAX package runs without a coordinator),
and `--steps_per_dispatch` / `--mesh_shape`, which parse and change nothing.
"""

import glob
import os
import uuid
from datetime import datetime

import numpy as np
import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..cues import InstanceEmbedder, SemanticsEmbedder
from ..data import DepthDataLoader, DevicePrefetcher
from ..data.prefetch import ARRAY_KEYS
from ..models import build_model
from ..utils import SummaryLogger, setup_exp_dir
from .loop import make_eval_step, make_train_step, validate
from .state import create_train_state

LOG_EVERY = 5  # reference train.py:432


def make_run_id(args) -> str:
    """Run-id naming convention (reference train.py:321-322)."""
    return (f"{datetime.now().strftime('%d-%h_%H-%M')}-nodebs{args.bs}-tep{args.epochs}"
            f"-lr{args.lr}-wd{args.wd}-{uuid.uuid4()}")


def _find_resume_checkpoint(resume: str, exp_dir):
    """Resolve --resume: an explicit path (which must exist), or 'latest' ->
    the newest *_latest.pt checkpoint under exp_dir, or None before the
    first one is written."""
    if resume != "latest":
        if not os.path.exists(resume):
            raise FileNotFoundError(f"--resume {resume}: no such checkpoint")
        return resume
    if not exp_dir:
        return None
    candidates = sorted(glob.glob(os.path.join(exp_dir, "*_latest.pt")), key=os.path.getmtime)
    return candidates[-1] if candidates else None


def main_train(args, max_steps=None, interactive=True):
    """Train per the parsed args; returns the final TrainState."""
    if getattr(args, "distributed", False) and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("multi-process training (DDP) is not ported yet "
                                  "(ROADMAP queue 1 item 4)")
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    run_id = make_run_id(args)  # one process names the run (under DDP, rank 0 would)
    args.batch_size = args.bs  # one device: the global batch

    torch.manual_seed(int(getattr(args, "seed", 42)))
    model = build_model(args).to(device)
    sem_embedder = SemanticsEmbedder(args, device) if args.use_semantics else None
    inst_embedder = InstanceEmbedder(args, device) if args.use_instance_segmentation else None

    train_loader = DepthDataLoader(args, "train")
    test_loader = DepthDataLoader(args, "online_eval")
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise ValueError("empty training split")
    state = create_train_state(model, args, steps_per_epoch)

    exp_dir = getattr(args, "exp_dir", None)
    if exp_dir is None:
        os.makedirs(args.root, exist_ok=True)
        exp_dir = setup_exp_dir(args.root, args.name, interactive=interactive)
        args.exp_dir = exp_dir

    resume = getattr(args, "resume", "")
    if resume:
        ckpt_path = _find_resume_checkpoint(resume, exp_dir)
        if ckpt_path:
            state, _ = load_checkpoint(ckpt_path, state)
            print(f"resumed from {ckpt_path} at step {state.step}")
    start_epoch, skip = divmod(state.step, steps_per_epoch)

    train_step = make_train_step(args, sem_embedder, inst_embedder)
    eval_step = make_eval_step(args, sem_embedder, inst_embedder)
    experiment_name = args.name
    logger = SummaryLogger(exp_dir)
    best_loss = np.inf
    step = state.step

    def bookkeep(metrics, epoch):
        """Logging, validation and checkpoints after one step; True when
        max_steps is reached."""
        nonlocal step, best_loss
        if step % LOG_EVERY == 0:
            logger.add_scalar("Train/Loss", metrics["loss"].item(), step)
            logger.add_scalar("Train/SILog", metrics["silog"].item(), step)
            logger.add_scalar("Train/ChamferLoss", metrics["chamfer"].item(), step)
        step += 1
        if step % args.validate_every == 0 or (max_steps and step >= max_steps):
            m, val_si = validate(args, eval_step, state.model,
                                 DevicePrefetcher(test_loader, device),
                                 max_batches=getattr(args, "max_val_batches", None))
            logger.add_scalar("Test/SILog", val_si.get_value(), step)
            for k, v in m.items():
                logger.add_scalar(f"Metrics/{k}", v, step)
            save_checkpoint(state, epoch, f"{experiment_name}_{run_id}_latest.pt", root=exp_dir)
            if m.get("abs_rel", np.inf) < best_loss:
                save_checkpoint(state, epoch, f"{experiment_name}_{run_id}_best.pt",
                                root=exp_dir)
                best_loss = m["abs_rel"]
        return max_steps is not None and step >= max_steps

    try:
        for epoch in range(start_epoch, args.epochs):
            logger.add_scalar("Epoch", epoch, step)
            train_loader.set_epoch(epoch, first_batch=skip if epoch == start_epoch else 0)
            for batch in DevicePrefetcher(train_loader, device):
                state, metrics = train_step(state, {k: v for k, v in batch.items()
                                                    if k in ARRAY_KEYS})
                if bookkeep(metrics, epoch):
                    return state
    finally:
        logger.close()
    return state
