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

`--pretrained_backbone FILE.npz` (a flax-layout backbone file, as
`mde_tpu.checkpoint.save_backbone_npz` writes it) loads the encoder's weights
and BN stats into the fresh model, as `mde_tpu/train/driver.py:41-64` does:
a stem widened by input cues keeps the file's RGB slice and its own cue
slice; with `--image none` the stem stays random.

Data parallelism (`--distributed` under `torchrun --nproc_per_node N -m
mde_tpu_torch.train ...`, `parallel/`): each data rank takes its share of
the global batch (`shard_batch_size`, the loader's `(rank, world_size)` set
to the data index and size), the model runs under DistributedDataParallel
(`train/state.py::wrap_ddp`) with BatchNorm and SILog over the global
batch, so the step is the JAX package's global step; rank 0 names the run
(its id and experiment directory go to every rank) and writes the scalars
and the checkpoints.

Tensor parallelism (`--distributed --mesh_shape d,m` with d·m ranks, as
`mde_tpu/train/driver.py:72, 117-120` builds its mesh and shards the
state): the grid's m model ranks of a data index read the same batch, and
the model is cut to each rank's slices (`models/tp.py::shard_model`) after
`--pretrained_backbone`, before the optimizer, and `--resume` loads the
gathered checkpoint into those slices. The forward then has collectives in
eval mode too, so every rank validates, draws the figures' forward and
saves (the checkpoint is gathered); rank 0 alone writes, and every rank
takes rank 0's metrics for the best-checkpoint test. With m = 1 rank 0
alone validates and saves (eval mode has no collective there).

Qualitative figures (`utils/graphs.py`, rank 0), at the JAX driver's cadence
(:173-193): `Train/QualSamples` when `step % 500 == 0`, after that step's
update, and `Test/QualSamples` at each validation, both from the batch just
trained. The figure forward runs the unwrapped model on that batch's first
two images, in eval mode under `torch.inference_mode` and the training's
compute dtype, then puts it back in train mode: parameters, BN buffers, the
optimizer and the dropout generator are left as they were. Each figure is a
PNG in the experiment directory and a JSONL line (`SummaryLogger.add_figure`).

Not ported: `--steps_per_dispatch` (a TPU dispatch workaround), which
parses and changes nothing.
"""

import glob
import os
import uuid
from datetime import datetime

import numpy as np
import torch

from ..checkpoint import (backbone_state_dict, load_backbone_npz, load_checkpoint,
                          save_checkpoint)
from ..cues import InstanceEmbedder, SemanticsEmbedder
from ..data import DepthDataLoader, DevicePrefetcher
from ..data.prefetch import ARRAY_KEYS
from ..models import build_model
from ..models.tp import shard_model
from ..parallel import (broadcast_object, destroy_distributed, grid, maybe_init_distributed,
                        shard_batch_size)
from ..utils import SummaryLogger, setup_exp_dir
from ..utils.graphs import GraphBuilderNYUD2, visualize_semantics
from .loop import eval_forward, make_eval_step, make_train_step, validate
from .state import create_train_state, wrap_ddp

LOG_EVERY = 5  # reference train.py:432
FIGURE_EVERY = 500  # reference train.py:437
FIGURE_SAMPLES = 2  # rows of the figure grid (mde_tpu/train/driver.py:148)


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


def apply_pretrained_backbone(model, args):
    """Load `args.pretrained_backbone` (an .npz of the encoder's flax trees)
    into `model`'s encoder, in place (`mde_tpu/train/driver.py:41-64`)."""
    path = getattr(args, "pretrained_backbone", None)
    if not path:
        return model
    params, stats = load_backbone_npz(path)
    encoder = model.encoder.original_model
    loaded = backbone_state_dict(params, stats, encoder.arch)
    stem = encoder.conv_stem.weight
    pretrained = loaded["conv_stem.weight"]
    if pretrained.shape != stem.shape:
        # input cues widen the stem: the file's RGB slice first, the cue
        # channels keep their initialisation; with image none the stem sees
        # cues only and stays random (reference unet_adaptive_bins.py:349-354)
        if getattr(args, "image", "rgb") == "none":
            loaded["conv_stem.weight"] = stem.detach().cpu()
        else:
            widened = stem.detach().cpu().clone()
            k = min(widened.shape[1], pretrained.shape[1])
            widened[:, :k] = pretrained[:, :k]
            loaded["conv_stem.weight"] = widened
    encoder.load_state_dict(loaded, strict=True)
    return model


def make_figure_forward(args, sem_embedder=None, inst_embedder=None):
    """forward(model, batch) -> the float32 prediction (n, 1, h, w) for the
    first FIGURE_SAMPLES images of a device batch: `model` (the unwrapped
    module, never the DDP wrapper: eval mode has no collective) in eval mode
    under `torch.inference_mode` and the training's compute dtype, as the JAX
    driver's `qual_forward` (:125-135); the model goes back to train mode."""
    bf16 = args.compute_dtype == "bfloat16"

    @torch.inference_mode()
    def forward(model, batch):
        part = {k: v[:FIGURE_SAMPLES] for k, v in batch.items() if k in ARRAY_KEYS}
        try:
            _, pred = eval_forward(model, part, bf16, sem_embedder, inst_embedder)
        finally:
            model.train()
        return pred.float()

    return forward


def log_qual_figure(logger, graph_builder, tag, args, batch, pred, step):
    """Build and write one qualitative grid (`mde_tpu/train/driver.py:339-355`):
    RGB, GT and prediction, and the raw cue maps coloured when the run reads
    them, from the batch's first FIGURE_SAMPLES images."""
    def host(t):
        return t[:FIGURE_SAMPLES].permute(0, 2, 3, 1).cpu().numpy()

    cue_colors = [visualize_semantics(host(batch[key]))
                  if flag is not None and key in batch else None
                  for key, flag in (("semantics", args.use_semantics),
                                    ("instance_labels", args.use_instance_segmentation))]
    graph_builder.add_image(host(batch["image"]), host(batch["depth"]), host(pred),
                            semantics=cue_colors[0], instance_labels=cue_colors[1])
    logger.add_figure(tag, graph_builder.image(), step)
    graph_builder.reset()


def main_train(args, max_steps=None, interactive=True):
    """Train per the parsed args; returns the final TrainState."""
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    started = not torch.distributed.is_initialized()
    rank, world_size = maybe_init_distributed(args)
    started = started and torch.distributed.is_initialized()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        return _train(args, device, rank, world_size, max_steps, interactive)
    finally:
        if started:
            destroy_distributed()


def _train(args, device, rank, world_size, max_steps, interactive):
    lead = rank == 0
    place = grid()
    # with a model group the forward has collectives in eval mode too: every
    # rank validates, draws the figures' forward and saves
    every_rank = place.model > 1
    run_id = broadcast_object(make_run_id(args))  # rank 0 names the run
    args.batch_size = shard_batch_size(args.bs, place.data,
                                       getattr(args, "use_new_batching", False))

    torch.manual_seed(int(getattr(args, "seed", 42)))
    model = shard_model(apply_pretrained_backbone(build_model(args), args), place).to(device)
    sem_embedder = SemanticsEmbedder(args, device) if args.use_semantics else None
    inst_embedder = InstanceEmbedder(args, device) if args.use_instance_segmentation else None

    train_loader = DepthDataLoader(args, "train", rank=place.data_index,
                                   world_size=place.data)
    test_loader = DepthDataLoader(args, "online_eval")
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise ValueError("empty training split")
    state = create_train_state(model, args, steps_per_epoch)

    exp_dir = getattr(args, "exp_dir", None)
    if exp_dir is None:
        if lead:
            os.makedirs(args.root, exist_ok=True)
            exp_dir = setup_exp_dir(args.root, args.name, interactive=interactive)
        exp_dir = broadcast_object(exp_dir)
        args.exp_dir = exp_dir

    resume = getattr(args, "resume", "")
    if resume:
        ckpt_path = _find_resume_checkpoint(resume, exp_dir)
        if ckpt_path:
            state, _ = load_checkpoint(ckpt_path, state)
            if lead:
                print(f"resumed from {ckpt_path} at step {state.step}")
    start_epoch, skip = divmod(state.step, steps_per_epoch)
    if torch.distributed.is_initialized():  # --distributed: DDP, at any world size
        wrap_ddp(state, [device.index] if device.type == "cuda" else None)

    train_step = make_train_step(args, sem_embedder, inst_embedder)
    eval_step = make_eval_step(args, sem_embedder, inst_embedder)
    figure_forward = make_figure_forward(args, sem_embedder, inst_embedder)
    experiment_name = args.name
    logger = SummaryLogger(exp_dir) if lead else None
    graph_builder = GraphBuilderNYUD2(
        num_samples=FIGURE_SAMPLES, semantics=args.use_semantics is not None,
        instance_labels=args.use_instance_segmentation is not None)
    best_loss = np.inf
    step = state.step

    def figure(tag, batch):
        pred = figure_forward(state.model, batch)
        if not lead:
            return
        log_qual_figure(logger, graph_builder, tag, args, batch, pred, step)

    def bookkeep(metrics, batch, epoch):
        """Logging, figures, validation and checkpoints after one step (rank
        0 writes; with a model group every rank runs the forwards and the
        save); True when max_steps is reached."""
        nonlocal step, best_loss
        if lead and step % LOG_EVERY == 0:
            logger.add_scalar("Train/Loss", metrics["loss"].item(), step)
            logger.add_scalar("Train/SILog", metrics["silog"].item(), step)
            logger.add_scalar("Train/ChamferLoss", metrics["chamfer"].item(), step)
        if (lead or every_rank) and step % FIGURE_EVERY == 0:
            figure("Train/QualSamples", batch)
        step += 1
        if (lead or every_rank) and (step % args.validate_every == 0
                                     or (max_steps and step >= max_steps)):
            m, val_si = validate(args, eval_step, state.model,
                                 DevicePrefetcher(test_loader, device),
                                 max_batches=getattr(args, "max_val_batches", None))
            if every_rank:  # one decision for the best checkpoint's collective
                m = broadcast_object(m)
            if lead:
                logger.add_scalar("Test/SILog", val_si.get_value(), step)
                for k, v in m.items():
                    logger.add_scalar(f"Metrics/{k}", v, step)
            # from the last train batch, as the JAX driver (:187-193)
            figure("Test/QualSamples", batch)
            save_checkpoint(state, epoch, f"{experiment_name}_{run_id}_latest.pt", root=exp_dir)
            if m.get("abs_rel", np.inf) < best_loss:
                save_checkpoint(state, epoch, f"{experiment_name}_{run_id}_best.pt",
                                root=exp_dir)
                best_loss = m["abs_rel"]
        return max_steps is not None and step >= max_steps

    try:
        for epoch in range(start_epoch, args.epochs):
            if lead:
                logger.add_scalar("Epoch", epoch, step)
            train_loader.set_epoch(epoch, first_batch=skip if epoch == start_epoch else 0)
            for batch in DevicePrefetcher(train_loader, device):
                state, metrics = train_step(state, {k: v for k, v in batch.items()
                                                    if k in ARRAY_KEYS})
                if bookkeep(metrics, batch, epoch):
                    return state
    finally:
        if lead:
            logger.close()
    return state
