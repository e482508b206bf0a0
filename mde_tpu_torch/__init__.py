"""mde_tpu_torch — the PyTorch / CUDA port of `mde_tpu`.

The JAX package `mde_tpu/` stays the reference; this package mirrors its
layout module for module so each port can be held against its counterpart:

  ops/       bin math, resizes, the training losses and the eval metrics
             (plain torch)
  kernels/   hand-written CUDA kernels for Hopper (sm_90a), each beside its
             plain PyTorch version; a wrapper launches the kernel for CUDA
             tensors and runs the plain version for CPU tensors; build.py
             builds csrc/ (nvcc, or g++ for the host library)
  csrc/      the CUDA C++ sources and the host library mdeaug.cpp (the JPEG
             and PNG decoders and the fused augmentation), built at first use
  cues/      semantic and instance cue embedders (table gathers, per-class
             areas, human sizes) on the device
  models/    EfficientNet encoder, UNet decoder, mViT bins head or the
             noAdaBins head, cue insertion at the input or before the mViT
             (NCHW)
  config/    the reference @file argument parsers
  data/      the NYU/KITTI dataset and loader, decoding, the native
             augmentation, transforms, and the prefetcher to the device
  checkpoint.py  training checkpoints (.pt, the reference layout), flax trees
             / reference .pt files -> port state_dicts
  train/     optimizer (AdamW + OneCycle + clip), train state, train step,
             eval step (in the training's compute dtype) and validate, the
             driver (main_train, with DDP, --pretrained_backbone and the
             qualitative figures) and the CLI (python -m mde_tpu_torch.train)
  parallel/  data parallelism: the process group, the in-model collectives
             (global-batch BatchNorm and SILog), shard_batch_size
  utils/     host-side helpers: colormaps.py (magma and inferno as tables,
             matplotlib's rule, no matplotlib), graphs.py (the figure grid,
             the semantic colour table), pointcloud.py (b64_to_pil, the
             Sobel edges, PointCloudHelper), colorize, the experiment
             directory, the logger (scalars and figures), running averages
  infer.py   InferenceHelper: the flip-TTA serving forward
  evaluate.py  official-split evaluation (python -m mde_tpu_torch.evaluate)
  offline/   cue generation: HRNetV2-W48 + C1 semantics and Swin-B Cascade
             Mask R-CNN instances, the two CLIs that write the cue side
             files (python -m mde_tpu_torch.offline.generate_*), their
             training and evaluation (train_detector, eval_detector,
             eval_semseg, hrnet_train) and CSAIL's semseg zoo
             (semseg_zoo.py: ResNet, ResNeXt, MobileNetV2 and HRNetV2
             encoders; C1, PPM and UPerNet decoders)

Slices ported so far: the serving forward, the training step, the cue
configurations (AdaBins and noAdaBins, cues at the input or before the mViT)
through the training step, the eval step and `validate`, training from files
through the CLI with its figures, evaluation, data-parallel training,
`--remat encoder`, `--pretrained_backbone`, the offline cue generators with
their training and evaluation, the semseg zoo and the demo utilities: all
of `mde_tpu` but tensor parallelism. The root script `orbax_to_pt.py`
(which needs JAX) turns the JAX package's orbax checkpoints into the port's
`.pt`. This package imports torch and never jax, flax, mde_tpu, PIL or
matplotlib.
"""

__version__ = "0.1.0"
