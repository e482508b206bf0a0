"""mde_tpu_torch — the PyTorch / CUDA port of `mde_tpu`.

The JAX package `mde_tpu/` stays the reference; this package mirrors its
layout module for module so each port can be held against its counterpart:

  ops/       bin math, resizes and the training losses (plain torch)
  kernels/   hand-written CUDA kernels for Hopper (sm_90a), each beside its
             plain PyTorch version; a wrapper launches the kernel for CUDA
             tensors and runs the plain version for CPU tensors
  csrc/      the CUDA C++ sources, built with nvcc at first use
  models/    EfficientNet encoder, UNet decoder, mViT bins head (NCHW)
  data/      host-side image normalization
  checkpoint.py  flax trees / reference .pt files -> port state_dicts
  train/     optimizer (AdamW + OneCycle + clip), train state, train step
  utils/     host-side helpers (colorize)
  infer.py   InferenceHelper: the flip-TTA serving forward

Slices ported so far: the serving forward and the training step (AdaBins,
no cues). This package imports torch and never jax, flax or mde_tpu.
"""

__version__ = "0.1.0"
