"""Official-split evaluation, the port's counterpart of `mde_tpu/evaluate.py`
and of the root `evaluate.py` (reference evaluate.py:50-179):

    python -m mde_tpu_torch.evaluate params/args_test_nyu.txt [overrides]

The params file parses as `evaluate.py` parses it (`EvalArgParser`,
`parse_cli(mode="eval")`); the port adds `--device` (cuda by default,
`--device cpu` on the CPU; a missing card is an error).

One forward a frame (the reference's `predict_tta` does no TTA), through
`train/loop.py::validate`: the `online_eval` loader's batches go to the
device through `DevicePrefetcher`, `make_eval_step` gives the per-image
masked metrics (prediction resized to the GT on the device, clamped,
eigen/garg crop) and the clamped prediction at the model's resolution from
the same forward; a frame without a GT goes through it too (JAX's save path
predicts it; without `--save_dir` JAX skips it). With `--save_dir`, that
prediction is resized to each GT's shape on the host
(`ops/resize.py::resize_bilinear_align_corners_np`, as `mde_tpu/evaluate.py`
:99-126 does), clipped, and written as a 16-bit PNG (x1000 NYU, x256 KITTI)
under the JAX package's names (`_save_prediction`, :27-38). Frames without
a GT are counted (`Total invalid`) and left out of the metrics; the rounded
metrics are printed and returned.

float32 is the default, as in JAX; `--compute_dtype bfloat16` runs the
forward under bf16 autocast (the head's tensor-core kernels). The model takes
the fused bins head, as the port's `InferenceHelper` does (the eval parser
has no `--use_fused_head`; JAX's evaluate runs its XLA head, the same
function), so a CUDA device runs the head kernel once a frame.

`--checkpoint_path` is a `.pt` file, in the reference or the port's layout
(`checkpoint.py::load_reference_checkpoint`). An orbax directory of the JAX
package is refused: `orbax_to_pt.py`, where JAX runs, converts it.
"""

import os

import numpy as np
import torch

from .checkpoint import load_reference_checkpoint
from .config import EvalArgParser, parse_cli
from .cues import InstanceEmbedder, SemanticsEmbedder
from .data import DepthDataLoader, DevicePrefetcher
from .data.decode import write_png
from .models import build_model
from .ops.resize import resize_bilinear_align_corners_np
from .train.loop import make_eval_step, validate


def prediction_path(image_path: str, args) -> tuple:
    """(PNG path, depth factor) of a frame's saved prediction
    (reference evaluate.py:114-126)."""
    if args.dataset == "nyu":
        impath = image_path.replace("/", "__").replace(".jpg", "")
        factor = 1000
    else:
        dpath = image_path.split("/")
        impath = (dpath[1] + "_" + dpath[-1]).split(".")[0]
        factor = 256
    return os.path.join(args.save_dir, f"{impath}.png"), factor


def load_eval_model(args, device) -> torch.nn.Module:
    """The configuration's model with `args.checkpoint_path`'s weights, on
    `device`, in eval mode."""
    path = args.checkpoint_path
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an orbax checkpoint of the JAX package: convert it "
            f"with `python orbax_to_pt.py <params file> --orbax_dir {path} --out FILE.pt` "
            f"where JAX runs, and pass the .pt")
    model = build_model(args)
    model.fused_head = True
    load_reference_checkpoint(model, path)
    return model.to(device).eval()


def run_evaluation(args, model=None, max_batches=None):
    """The evaluation loop; returns (metrics, unrounded, over the frames with
    a GT; the count of frames without one)."""
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to evaluate on the CPU")
    if model is None:
        model = load_eval_model(args, device)
    sem_embedder = SemanticsEmbedder(args, device) if args.use_semantics else None
    inst_embedder = InstanceEmbedder(args, device) if args.use_instance_segmentation else None
    if args.save_dir is not None:
        os.makedirs(args.save_dir, exist_ok=True)
    eval_step = make_eval_step(args, sem_embedder, inst_embedder)
    min_d, max_d = float(args.min_depth_eval), float(args.max_depth_eval)
    total_invalid = 0

    def on_batch(batch, pred):
        nonlocal total_invalid
        n = batch["depth"].shape[0]
        valid = np.asarray(batch.get("has_valid_depth", np.ones(n, bool)), bool).reshape(-1)
        total_invalid += int(np.sum(~valid))
        if args.save_dir is None:
            return
        hw = tuple(batch["depth"].shape[-2:])
        final = np.clip(resize_bilinear_align_corners_np(
            pred.permute(0, 2, 3, 1).cpu().numpy(), hw), min_d, max_d)
        for j in range(n):
            path, factor = prediction_path(batch["image_path"][j], args)
            write_png(path, (final[j, ..., 0] * factor).astype("uint16"))

    loader = DevicePrefetcher(DepthDataLoader(args, "online_eval"), device)
    vals, _ = validate(args, eval_step, model, loader, max_batches, on_batch)
    return vals, total_invalid


def evaluate(args, model=None, max_batches=None):
    """Run the official-split eval; prints and returns the rounded metrics."""
    vals, total_invalid = run_evaluation(args, model, max_batches)
    print(f"Total invalid: {total_invalid}")
    rounded = {k: round(v, 3) for k, v in vals.items()}
    print(f"Metrics: {rounded}")
    return rounded


def main(argv=None):
    parser = EvalArgParser(description="Model evaluator", fromfile_prefix_chars="@",
                           conflict_handler="resolve")
    return evaluate(parse_cli(parser, argv, mode="eval"))


if __name__ == "__main__":
    main()
