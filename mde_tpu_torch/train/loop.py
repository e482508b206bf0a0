"""The training and eval steps and validation, port of `mde_tpu/train/loop.py`
(`make_train_step` :50-139, reference train.py:387-455; `make_eval_step`
:167-205 and `validate` :208-242, reference train.py:505-568), NCHW.

Cues: a batch may carry raw `semantics`, `instance_labels` and
`instance_areas` maps, (N, 1, H, W) each; the embedders given to the step
(cues/embedders.py) turn them into cue channels on the batch's device before
the forward, as the JAX step does inside its jit.

One training step: forward in train mode (batch-statistics BatchNorm, mViT
dropout), SILog after the align-corners resize to the GT size over the
pixels with depth > min_depth, plus w_chamfer x the bins-chamfer loss (none
for the noAdaBins head, which has no bins), backward, the global-norm clip
and the AdamW update with the scheduled lr and beta1.

* `--compute_dtype bfloat16` (the JAX training run's default) runs the
  forward and the loss under `torch.autocast(bfloat16)` over float32
  parameters.
* `--use_fused_head` (a model flag) sends the head through the bins-head
  kernels, `--use_pallas_chamfer` the chamfer through the chamfer kernel
  (kernels/chamfer.py); without it the chunked `bins_chamfer_loss` runs.
  On CPU tensors both run their plain versions.
* `--accum_steps K` splits the batch into K micro-batches run one after the
  other, and applies their mean gradient once; BN running stats thread
  through them as through K forwards.
* The dropout masks of step s (micro-batch i) come from a generator seeded
  with (args.seed, s, i), as the JAX step folds its rng per step; with
  several ranks, (args.seed, s, i, rank).
* Several ranks (`parallel/`, `TrainState.ddp`): the step gives the numbers
  of the JAX step on the global batch (`mde_tpu/kernels/sharded.py`'s
  semantics). BatchNorm's moments (models/norm.py) and SILog's count and
  sums are summed over the ranks inside autograd, so every rank computes
  the global SILog; the chamfer, a mean of per-image losses, runs on the
  rank's shard, and DDP's gradient mean plays the part of
  `chamfer_1d_pallas_sharded`'s pmean. The scaling is exact: the backward of
  a sum all-reduce sums the ranks' gradients, so rank r's gradient is
  R x its share of d(SILog)/dθ plus its shard's d(chamfer_r)/dθ, and DDP's
  mean over the R ranks is d(SILog + w mean_r chamfer_r)/dθ, the global
  gradient. DDP syncs on the last micro-batch of `--accum_steps` only
  (`no_sync` before it); the logged loss, SILog and chamfer are means over
  the ranks.

The eval step runs on the device under `torch.inference_mode()`: the
forward with no TTA, in the training's compute dtype (bf16 autocast at
`--compute_dtype bfloat16`, as the JAX eval step runs its bf16 model), the
float32 prediction resized (align corners) to the GT's size, per-image
SILog, the clamp to the eval range with inf and NaN scrubbed, and the
masked metrics per image. `validate` feeds it any iterable
of batch dicts and averages per sample, as the reference does at batch 1.

Not ported: `make_multi_step` and `--steps_per_dispatch` (a TPU dispatch
workaround). `train/driver.py` drives these steps from files.
"""

import contextlib

import numpy as np
import torch

from ..kernels.chamfer import chamfer_1d
from ..ops.losses import bins_chamfer_loss, silog_loss
from ..ops.metrics import METRIC_NAMES, compute_errors_masked, eval_mask
from ..ops.resize import resize_bilinear_align_corners
from ..parallel import all_reduce_mean, world
from ..utils.running_average import RunningAverage, RunningAverageDict
from .state import TrainState

_EVAL_KEYS = ("image", "depth", "semantics", "instance_labels", "instance_areas")


def _embed_cues(batch, sem_embedder, inst_embedder):
    semantics = instance_labels = instance_areas = None
    if "semantics" in batch and sem_embedder is not None:
        _, semantics = sem_embedder(batch["semantics"])
    if "instance_labels" in batch and inst_embedder is not None:
        _, instance_labels, instance_areas = inst_embedder(
            batch["instance_labels"], batch["instance_areas"])
    return semantics, instance_labels, instance_areas


def make_loss_fn(args, sem_embedder=None, inst_embedder=None):
    """loss_fn(model, batch, generator) -> (loss, silog, chamfer), for a batch
    {"image": (N, 3, H, W), "depth": (N, 1, H, W)} and the raw cue maps the
    embedders take. The caller takes the gradients."""
    w_chamfer = float(args.w_chamfer)
    use_chamfer = bool(args.chamfer) and w_chamfer != 0.0
    min_depth = float(args.min_depth)
    chamfer_fn = chamfer_1d if args.use_pallas_chamfer else bins_chamfer_loss
    bf16 = args.compute_dtype == "bfloat16"

    def loss_fn(model, batch, generator=None):
        image, depth = batch["image"], batch["depth"]
        cues = _embed_cues(batch, sem_embedder, inst_embedder)
        with torch.autocast(image.device.type, dtype=torch.bfloat16, enabled=bf16):
            bin_edges, pred = model(image, *cues, generator=generator)
            l_dense = silog_loss(pred, depth, depth > min_depth, interpolate=True,
                                 global_batch=True)
            if use_chamfer and bin_edges is not None:
                l_chamfer = chamfer_fn(bin_edges, depth)
            else:
                l_chamfer = torch.zeros((), device=image.device)
            loss = l_dense + w_chamfer * l_chamfer
        return loss, l_dense, l_chamfer

    return loss_fn


def _dropout_seed(seed: int, step: int, micro: int, rank=None) -> int:
    entropy = [seed, step, micro] + ([] if rank is None else [rank])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def make_train_step(args, sem_embedder=None, inst_embedder=None):
    """train_step(state, batch) -> (state, metrics): one update of
    `state.model` in place. Metrics are 0-d tensors on the batch's device
    (`loss`, `silog`, `chamfer`); reading them waits for the step."""
    loss_fn = make_loss_fn(args, sem_embedder, inst_embedder)
    accum = max(1, int(args.accum_steps))
    seed = int(args.seed)

    def train_step(state: TrainState, batch):
        state.model.train()
        net = state.ddp if state.ddp is not None else state.model
        rank, world_size = world()
        image = batch["image"]
        generator = torch.Generator(device=image.device)
        state.optimizer.zero_grad()
        bs = image.shape[0]
        if bs % accum:
            raise ValueError(f"batch size {bs} must divide --accum_steps {accum}")
        size = bs // accum
        sums = torch.zeros(3, device=image.device)
        for i in range(accum):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            generator.manual_seed(_dropout_seed(seed, state.step, i,
                                                rank if world_size > 1 else None))
            sync = state.ddp is None or i == accum - 1
            with contextlib.nullcontext() if sync else state.ddp.no_sync():
                loss, l_dense, l_chamfer = loss_fn(net, micro, generator)
                (loss / accum).backward()
            sums += torch.stack([loss, l_dense, l_chamfer]).detach().float()
        state.optimizer.step(state.step)
        state.step += 1
        loss, l_dense, l_chamfer = all_reduce_mean(sums / accum)
        return state, {"loss": loss, "silog": l_dense, "chamfer": l_chamfer}

    return train_step


def clamp_prediction(pred, min_d: float, max_d: float):
    """The eval clamp (reference evaluate.py:60-64): into [min_d, max_d],
    inf to max_d, NaN to min_d."""
    pred = torch.clamp(pred, min_d, max_d)
    pred = torch.where(torch.isinf(pred), max_d, pred)
    return torch.where(torch.isnan(pred), min_d, pred)


def eval_forward(model, batch, bf16: bool, sem_embedder=None, inst_embedder=None):
    """The model in eval mode on a batch on its device: the cues embedded,
    then the forward, under bf16 autocast when `bf16` (the training's
    compute dtype, as the JAX package builds its one model in it). Returns
    the model's (bin_edges, pred)."""
    model.eval()
    cues = _embed_cues(batch, sem_embedder, inst_embedder)
    image = batch["image"]
    with torch.autocast(image.device.type, dtype=torch.bfloat16, enabled=bf16):
        return model(image, *cues)


def make_eval_step(args, sem_embedder=None, inst_embedder=None):
    """eval_step(model, batch, crop_mask) -> (silog (N,), metrics, pred): the
    model in eval mode on a batch on its device, its forward in
    `args.compute_dtype` (`eval_forward`), `crop_mask` (H, W) boolean at the
    GT's size. `metrics` maps each of METRIC_NAMES to an (N,) tensor;
    `pred` is the float32 prediction at the model's resolution, clamped to
    the eval range with inf and NaN scrubbed (what `evaluate`'s save path
    resizes on the host), from the same forward."""
    min_d, max_d = float(args.min_depth_eval), float(args.max_depth_eval)
    min_depth = float(args.min_depth)
    bf16 = getattr(args, "compute_dtype", "float32") == "bfloat16"

    @torch.inference_mode()
    def eval_step(model, batch, crop_mask):
        _, raw = eval_forward(model, batch, bf16, sem_embedder, inst_embedder)
        # metric math stays float32 whatever the model computes in
        # (mde_tpu/train/loop.py:181-183)
        depth = batch["depth"]
        pred = resize_bilinear_align_corners(raw.float(), depth.shape[-2:])
        # per-image SILog, so the host can drop invalid-depth samples alone
        l_dense = torch.stack([
            silog_loss(p[None], d[None], (d > min_depth)[None], interpolate=False)
            for p, d in zip(pred, depth)])
        pred = clamp_prediction(pred, min_d, max_d)

        gt, pr = depth[:, 0], pred[:, 0]
        valid = (gt > min_d) & (gt < max_d) & crop_mask[None]
        metrics = compute_errors_masked(gt, pr, valid, dim=(-2, -1))
        return l_dense, metrics, clamp_prediction(raw.float(), min_d, max_d)

    return eval_step


def validate(args, eval_step, model, test_loader, max_batches=None, on_batch=None):
    """Online validation over any iterable of batch dicts (host or device
    tensors, moved to the model's device); returns (metric dict, the
    RunningAverage of the per-sample val SILog). Samples whose
    `has_valid_depth` is false are skipped one by one (reference
    train.py:516-518); the crop follows each batch's GT size. With
    `on_batch`, every batch goes through the step, with or without a valid
    sample, and `on_batch(batch, pred)` gets it with the step's prediction
    (evaluate.py's count of frames without a GT and its save path)."""
    device = next(model.parameters()).device
    val_si = RunningAverage()
    metrics = RunningAverageDict()
    crops = {}
    for i, batch in enumerate(test_loader):
        if max_batches is not None and i >= max_batches:
            break
        bs = batch["depth"].shape[0]
        valid = (torch.as_tensor(batch["has_valid_depth"]).reshape(-1).bool().tolist()
                 if "has_valid_depth" in batch else [True] * bs)
        if not (any(valid) or on_batch):
            continue
        gt_hw = tuple(batch["depth"].shape[-2:])
        if gt_hw not in crops:
            crops[gt_hw] = torch.from_numpy(eval_mask(
                gt_hw, args.dataset, args.garg_crop, args.eigen_crop)).to(device)
        arrays = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
                  if k in _EVAL_KEYS}
        si, m, pred = eval_step(model, arrays, crops[gt_hw])
        if on_batch is not None:
            on_batch(batch, pred)
        values = torch.stack([si] + [m[k] for k in METRIC_NAMES]).cpu().numpy()
        for j in range(bs):
            if not valid[j]:
                continue
            val_si.append(float(values[0, j]))
            metrics.update({k: float(values[1 + n, j]) for n, k in enumerate(METRIC_NAMES)})
    vals = metrics.get_value() if metrics._dict else {k: float("nan") for k in METRIC_NAMES}
    return vals, val_si
