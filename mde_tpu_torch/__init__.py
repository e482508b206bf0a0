"""mde_tpu_torch — the PyTorch / CUDA port of `mde_tpu`.

The JAX package `mde_tpu/` stays the reference; this package mirrors its
layout module for module so each port can be held against its counterpart:

  ops/       bin math, resizes, the training losses and the eval metrics
             (plain torch)
  kernels/   hand-written CUDA kernels for Hopper (sm_90a), each beside its
             plain PyTorch version; a wrapper launches the kernel for CUDA
             tensors and runs the plain version for CPU tensors
  csrc/      the CUDA C++ sources, built with nvcc at first use
  cues/      semantic and instance cue embedders (table gathers, per-class
             areas, human sizes) on the device
  models/    EfficientNet encoder, UNet decoder, mViT bins head or the
             noAdaBins head, cue insertion at the input or before the mViT
             (NCHW)
  data/      host-side image normalization
  checkpoint.py  flax trees / reference .pt files -> port state_dicts
  train/     optimizer (AdamW + OneCycle + clip), train state, train step,
             eval step and validate
  utils/     host-side helpers (colorize, running averages)
  infer.py   InferenceHelper: the flip-TTA serving forward

Slices ported so far: the serving forward, the training step, and the cue
configurations (AdaBins and noAdaBins, cues at the input or before the mViT)
through the training step, the eval step and `validate`. This package
imports torch and never jax, flax or mde_tpu.
"""

__version__ = "0.1.0"
