"""Train the Swin-B Cascade Mask R-CNN on COCO-format instance annotations,
the port of `scripts/train_detector.py` (the reference's Swin…/tools/train.py
with the ade20k config: AdamW 1e-4, weight decay 0.05 paramwise, step decay
at epochs 27 and 33 of 36, DETR-style AutoAugment):

    python -m mde_tpu_torch.offline.train_detector --images ade20k/images \\
        --annotations inst_train.json --num-classes 100 [--pretrained det.pth] \\
        [--epochs 36] [--out runs/det] [--max-steps N] [--fixed-scale 800,1333]

One image a step, in bfloat16 from float32 master weights (`cast_at_use`),
each Swin block recomputed in the backward (`use_checkpoint`), the bbox
heads' BatchNorms over each stage's sampled rois. The sampler draws from a
torch.Generator on the card seeded with --seed + 1; the AutoAugment draws
from numpy's default_rng(--seed), first one sample as the JAX script's init
does, so one seed gives its sample sequence. Checkpoints are in mmdet's
runner layout ({"state_dict", "optimizer", "meta": {"epoch", "iter"}}),
`detector_step{N}.pth` every --save-every steps and `detector_latest.pth` at
the end of each epoch, so `load_detector`, `generate_instances --checkpoint`
and `eval_detector` read them as a published file (the JAX script writes
orbax trees). --pretrained loads an mmdet checkpoint through `load_detector`;
a file whose keys differ keeps the seeded initialisation and says why. The
run is on the card unless --device cpu; a missing card is an error.
"""

import argparse
import os
import time

import numpy as np
import torch

from .cascade_rcnn import CascadeMaskRCNN, load_detector
from .coco_dataset import CocoInstanceDataset
from .detection_data import AugScales, detector_optimizer, fixed_scales
from .detection_train import generator_uniform
from .generate_semantics import device_of
from .layers import cast_at_use, seeded

COMPUTE_DTYPE = torch.bfloat16


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True)
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--num-classes", type=int, default=100)
    ap.add_argument("--pretrained", default=None, help="mmdet .pth to warm-start from")
    ap.add_argument("--epochs", type=int, default=36)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--wd", type=float, default=0.05)
    ap.add_argument("--out", default="./runs/detector")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--save-every", type=int, default=2000)
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after N optimizer steps (0 = run all epochs)")
    ap.add_argument("--max-gt", type=int, default=100,
                    help="static GT padding capacity per image")
    ap.add_argument("--fixed-scale", default=None, metavar="SHORT,LONG",
                    help="pin the AutoAugment scale set to one (short, long) pair")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_detector(args, device) -> CascadeMaskRCNN:
    """The seeded detector, warm-started from --pretrained where its keys
    match, float32 weights computing in bfloat16, in training mode."""
    model = seeded(lambda: CascadeMaskRCNN(args.num_classes, use_checkpoint=True), args.seed)
    if args.pretrained:
        try:
            loaded = load_detector(args.pretrained, num_classes=args.num_classes)
            model.load_state_dict(loaded.state_dict(), strict=True)
            print(f"warm-started from {args.pretrained}")
        except KeyError as e:
            print(f"partial checkpoint ({e}); keeping random init for missing parts")
    return cast_at_use(model, COMPUTE_DTYPE).to(device).train()


def train_step(model, optimizer, scheduler, sample, uniform, num_samples: int = 512) -> dict:
    """One optimizer step on one `train_sample`: the sample to the model's
    device (masks as uint8, only the valid GTs' and at least one), the
    losses, the backward, AdamW and the schedule's step. Returns the losses
    as detached device tensors; nothing is read back to the host."""
    device = next(model.parameters()).device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)

    n_masks = max(int(sample["gt_valid"].sum()), 1)
    image = put(sample["image"]).permute(2, 0, 1)[None]
    optimizer.zero_grad(set_to_none=True)
    losses = model.compute_losses(image, put(sample["gt_boxes"]), put(sample["gt_labels"]).long(),
                                  put(sample["gt_valid"]), put(sample["gt_masks"][:n_masks]),
                                  uniform, tuple(sample["valid_hw"]), num_samples)
    losses["total"].backward()
    optimizer.step()
    scheduler.step()
    return {k: v.detach() for k, v in losses.items()}


def save_checkpoint(path, model, optimizer, epoch: int, step: int) -> None:
    """mmdet's runner layout: state_dict (float32), optimizer, meta (epoch:
    the epochs completed, iter: the optimizer steps)."""
    torch.save({"state_dict": model.state_dict(), "optimizer": optimizer.state_dict(),
                "meta": {"epoch": epoch, "iter": step}}, path)


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    scales = AugScales()
    if args.fixed_scale:
        scales = fixed_scales(*(int(v) for v in args.fixed_scale.split(",")))
    ds = CocoInstanceDataset(args.images, args.annotations)
    print(f"{len(ds)} annotated images")
    steps_per_epoch = len(ds)
    rng = np.random.default_rng(args.seed)
    ds.train_sample(rng, 0, max_gt=args.max_gt, scales=scales)  # the JAX script's init sample
    model = build_detector(args, device)
    optimizer, scheduler = detector_optimizer(model, base_lr=args.lr, weight_decay=args.wd,
                                              steps_per_epoch=steps_per_epoch)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    uniform = generator_uniform(gen)
    os.makedirs(args.out, exist_ok=True)
    step = 0
    t0 = time.time()
    done = False
    for epoch in range(args.epochs):
        for idx in rng.permutation(len(ds)):
            sample = ds.train_sample(rng, int(idx), max_gt=args.max_gt, scales=scales)
            losses = train_step(model, optimizer, scheduler, sample, uniform)
            step += 1
            if step % args.log_every == 0:
                print(f"e{epoch} s{step}: total {float(losses['total']):.4f} "
                      f"rpn {float(losses['rpn_cls']):.3f}/{float(losses['rpn_reg']):.3f} "
                      f"({step / (time.time() - t0):.2f} it/s)")
            if step % args.save_every == 0:
                save_checkpoint(os.path.join(args.out, f"detector_step{step}.pth"), model,
                                optimizer, epoch, step)
            if args.max_steps and step >= args.max_steps:
                done = True
                break
        save_checkpoint(os.path.join(args.out, "detector_latest.pth"), model, optimizer,
                        epoch + 1, step)
        if done:
            break
    print("done")
    return model


if __name__ == "__main__":
    main()
