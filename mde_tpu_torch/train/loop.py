"""The training step, port of `mde_tpu/train/loop.py::make_train_step`
(:50-139; reference train.py:387-455), NCHW.

One step: forward in train mode (batch-statistics BatchNorm, mViT dropout),
SILog after the align-corners resize to the GT size over the pixels with
depth > min_depth, plus w_chamfer x the bins-chamfer loss, backward, the
global-norm clip and the AdamW update with the scheduled lr and beta1.

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
  with (args.seed, s, i), as the JAX step folds its rng per step.

Not ported: `make_multi_step` and `--steps_per_dispatch` (a TPU dispatch
workaround); `make_eval_step`, `validate` and `train/driver.py` wait for the
dataset (ROADMAP queue 1).
"""

import numpy as np
import torch

from ..kernels.chamfer import chamfer_1d
from ..ops.losses import bins_chamfer_loss, silog_loss
from .state import TrainState


def make_loss_fn(args):
    """loss_fn(model, batch, generator) -> (loss, silog, chamfer), for a batch
    {"image": (N, 3, H, W), "depth": (N, 1, H, W)}. The caller takes the
    gradients."""
    w_chamfer = float(args.w_chamfer)
    use_chamfer = bool(args.chamfer) and w_chamfer != 0.0
    min_depth = float(args.min_depth)
    chamfer_fn = chamfer_1d if args.use_pallas_chamfer else bins_chamfer_loss
    bf16 = args.compute_dtype == "bfloat16"

    def loss_fn(model, batch, generator=None):
        image, depth = batch["image"], batch["depth"]
        with torch.autocast(image.device.type, dtype=torch.bfloat16, enabled=bf16):
            bin_edges, pred = model(image, generator)
            l_dense = silog_loss(pred, depth, depth > min_depth, interpolate=True)
            if use_chamfer:
                l_chamfer = chamfer_fn(bin_edges, depth)
            else:
                l_chamfer = torch.zeros((), device=image.device)
            loss = l_dense + w_chamfer * l_chamfer
        return loss, l_dense, l_chamfer

    return loss_fn


def _dropout_seed(seed: int, step: int, micro: int) -> int:
    return int(np.random.SeedSequence([seed, step, micro]).generate_state(1)[0])


def make_train_step(args):
    """train_step(state, batch) -> (state, metrics): one update of
    `state.model` in place. Metrics are 0-d tensors on the batch's device
    (`loss`, `silog`, `chamfer`); reading them waits for the step."""
    loss_fn = make_loss_fn(args)
    accum = max(1, int(args.accum_steps))
    seed = int(args.seed)

    def train_step(state: TrainState, batch):
        model = state.model.train()
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
            generator.manual_seed(_dropout_seed(seed, state.step, i))
            loss, l_dense, l_chamfer = loss_fn(model, micro, generator)
            (loss / accum).backward()
            sums += torch.stack([loss, l_dense, l_chamfer]).detach().float()
        state.optimizer.step(state.step)
        state.step += 1
        loss, l_dense, l_chamfer = sums / accum
        return state, {"loss": loss, "silog": l_dense, "chamfer": l_chamfer}

    return train_step
