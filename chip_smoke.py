#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`mde_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile DIR   # also write profiler tables to DIR,
                                          # and the cue ops' share of the A step

Phases, each of which ends the run with a non-zero exit if it fails:
  1. toolchain: torch, CUDA, nvcc, device capability, triton, card and power,
     and whether matplotlib and scipy are there (the figures will need them)
  2. build the kernels of mde_tpu_torch/csrc with nvcc, one process per
     source, all at once (bins_head.cu: the float32 head forward and
     backward on the CUDA cores; bins_head_tc.cu: the bfloat16 head forward
     and backward on the tensor cores; chamfer.cu: chamfer reductions), and
     beside them the host library mdeaug.cpp (the JPEG/PNG decoders and the
     augmentation) with g++
  3. each kernel against its plain PyTorch version: the head forward at the
     serving shape (B=2, 240x320 pixels) and, with the head backward, at the
     training shape (B=16, 208x272 pixels), 128 channels, 256 bins, float32
     (CUDA-core kernels) and bfloat16 (tensor-core kernels), the float32
     forward's share of its bound at both shapes (timed also writing the
     softmax stats a backward reads), the backward's share of its bound,
     each backward timed from its forward's saved stats; the bf16 kernels again at
     1,024 bins, where W goes through shared memory in chunks; the chamfer
     reductions at (16 images of 416x544 pixels, 256 bins) on uniform noise
     and on a smooth millimetre-quantized map, each timed with its share of
     the bound, and the loss and gradient on the noise; and, as yardsticks of the card's rates, two cuBLAS products of
     the head's sizes (bf16 at the training shape, float32 with TF32 off at
     the serving shape), which the port never calls
  4. the serving path: InferenceHelper (EfficientNet-B1, 256 bins, seeded
     random weights) answers 8 requests of 480x640 frames, each through the
     float32 head forward kernel
  5. the training path: create_train_state + make_train_step in the flagship
     configuration (B1 AdaBins, 256 bins, 416x544, batch 16, bf16 autocast,
     AdamW + OneCycle + clip 0.1, SILog + 0.1 x chamfer, both kernels) on a
     device-resident synthetic batch: 2 warm-up and 8 timed steps, each of
     which must launch the tensor-core head forward and the chamfer kernel
     once and the two tensor-core head backward kernels once each
  6. one step at batch 2 through the kernels against the same step through
     the unfused head and the plain chamfer, in float32 (the CUDA-core head
     kernels) and under bf16 autocast (the tensor-core ones)
  7. the cue configurations of the paper's params files, with seeded random
     weights: (A) glove-25d semantics + ade20k_swin_human_sizes instances at
     the input, a 73-channel stem; (B) glove-25d-inst-areas + coco before the
     mViT, a 198-channel patch conv and conv3x3; (C) A's cues on the
     noAdaBins head:
     - the cue embedders on the card against the same embedders on the CPU,
       on labels with -1 and out-of-range values (equal, NaN alike, no
       device-side assert)
     - A and B, and the no-cue model beside them, through make_eval_step +
       validate, float32, 20 frames of 480x640 at batch 1 (with --profile,
       4 more under the profiler): one float32 head-forward launch a frame and no
       other kernel, each frame's depth within 1e-4 m of the plain head's, the
       card's masked metrics within 1e-4 relative of float64 `compute_errors`
       on the host, every metric finite
     - A through the phase-5 training step (2 + 8 steps, 1/2/1 launches a
       step, every parameter changed, the CueMLPs and the wide stem too)
     - B through the phase-6 step check, float32 and bf16, the CueMLPs'
       gradients held with conv_out's and the regressor's
     - C: one training step at batch 16 and one eval frame, finite, and no
       kernel launched (no bins head, no chamfer)
  8. the train CLI: an NYU-format tree of 128 train and 16 eval frames
     (every RGB file a copy of test_imgs/classroom__rgb_00283.jpg, each
     depth a smooth per-frame millimetre map written as a 16-bit PNG); the
     port's decode of that JPEG against the SHA-256 of PIL's decode; then
     parse_cli(params/args_train_nyu_efficientnet-b1.txt, --bs 16 --epochs
     2 --validate_every 6, the tree's paths) and main_train(max_steps=12):
     the flagship through the native loader, the prefetcher, the driver,
     two validations of the 16 frames at batch 1 in float32, latest and best
     checkpoints; exactly 12 x (1, 2, 1) bf16 head forward / backward and
     chamfer launches and one float32 head forward an eval frame, finite
     losses, the JSONL's tags and steps at the JAX driver's cadence; then
     --resume latest with max_steps=14: epoch 1, update 12, two steps, the
     learning rate of OneCycle's update 13. Prints the driver's median step
     beside phase 5's synthetic step, the loader's time for one batch of 16
     alone, the validation ms a frame, the checkpoint save ms and bytes, the
     peak device memory and (with --profile) the device's busy share over
     steps 3-8 through the driver
  9. evaluation, data parallelism, remat and the pretrained backbone, on the
     phase-8 tree:
     (a) `python -m mde_tpu_torch.evaluate params/args_test_nyu.txt` in
         process (`main(argv)`): B5, 256 bins, float32, the 16 eval frames
         of 480x640 at batch 1, a seeded B5 checkpoint written by
         save_checkpoint, --save_dir; exactly one float32 head forward a
         frame and no other kernel, finite rounded metrics, one 16-bit PNG a
         frame under the JAX package's names, the metrics within 1e-4
         relative of the same frames through the plain head; ms a frame and
         peak bytes
     (b) two gloo ranks spawned on the one card (NCCL refuses two ranks on
         one device), the flagship under DDP at a global batch of 16, 8 a
         rank: 2 warm-up and 6 timed bf16 steps, 1/2/1 bf16 head forward /
         backward and chamfer launches a rank a step, equal losses on the
         ranks; 6 interleaved pairs of bf16 steps timing DDP's former
         find_unused_parameters=True beside wrap_ddp's ignore list (launches
         not counted); one float32 step, the mViT's dropout off (the ranks draw
         their own masks), against one process's on the 16 images (loss
         rtol 2e-4, gradients within 2e-2 of the largest value, equal on
         the ranks); then main_train under --distributed with a
         torchrun environment of one rank: NCCL, the DDP wrapper, 2 steps
         and a validation with their exact launches
     (c) --remat encoder: its first step against the step without remat
         from the phase-5 weights (loss within 1e-3, BN buffers moved once),
         then 2 + 8 timed steps beside phase 5's: a lower peak
     (d) --pretrained_backbone: a seeded B1 .npz into configuration A's
         73-channel stem: the RGB slice the file's, the cue slice untouched,
         every other weight and BN stat the file's
     and phase 3 also times chamfer_wide_kernel (512 bins, on no main path)
     against its plain version and its bound.
 10. one JSON line on the kernels (launches summed over the main paths:
     serving, training, the eval and cue training runs, the train CLI, the
     B5 evaluation, both DDP ranks, the DDP driver run and the remat steps;
     the float32 head backward, which no main path runs, from the float32
     step checks), then the result line.

float32 comparisons run with TF32 off for both cuDNN and cuBLAS. The script
imports no JAX: it is the quickest proof that the port runs on the card.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REQUESTS = 8
FRAME_HW = (480, 640)
TRAIN_HW = (416, 544)
TRAIN_BATCH = 16
WARMUP_STEPS, TIMED_STEPS = 2, 8
N_BINS = 256
CHUNKED_BINS = 1024  # above the 640 bins the bf16 kernels keep resident
SEED = 0
EVAL_FRAMES = 20
# the cue configurations, from params/args_train_nyu_efficientnet-b1_sem_glove-
# 25d_inst_ade20k_swin_human_sizes_insertion_point_input.txt (A), params/args_
# train_nyu_efficientnet-b1_sem_glove-25d-inst-areas_inst_coco.txt (B, whose
# insertion point is the parser's default, before-attn) and params/args_train_
# nyu_efficientnet-b1-noAdaBins_sem_glove-25d_inst_ade20k_swin_human_sizes_
# insertion_point_input.txt (C)
CUE_CONFIGS = {
    "A": dict(use_semantics="glove-25d", use_instance_segmentation="ade20k_swin_human_sizes",
              insertion_point="input"),
    "B": dict(use_semantics="glove-25d-inst-areas", use_instance_segmentation="coco",
              insertion_point="before-attn"),
    "C": dict(encoder_name="efficientnet-b1-noAdaBins", use_semantics="glove-25d",
              use_instance_segmentation="ade20k_swin_human_sizes", insertion_point="input"),
}
CUE_MLP_PREFIXES = ("semantics_areas_fc.", "semantics_absolute_sizes_fc.",
                    "instance_areas_fc.", "instance_absolute_sizes_fc.")
METRIC_TOL = 1e-4  # card's float32 masked metrics vs float64 on the host, relative
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # rtol = atol
# gradients, of the tensor's largest value; bf16 per gradient: dx is rounded
# to bf16, dW and db are f32 sums on both sides, as in the JAX kernel, and
# differ where a logit's f32 sum rounds to the other bf16 neighbour in the
# kernel's order (tests/test_torch_port_cuda.py GRAD_TOL)
GRAD_TOL = {torch.float32: dict.fromkeys(("dx", "dW", "db", "dcenters"), 1e-4),
            torch.bfloat16: {"dx": 2e-2, "dW": 1e-3, "db": 1e-3, "dcenters": 2e-2}}
HEAD_TOL = 1e-4  # metres, fused vs plain head on the same model, rtol 1e-5
# kernels vs plain step: loss rtol, gradients of the largest value
STEP_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# kernel launches per training step; a head backward call launches two
# kernels (the pixel and the weight kernel). bf16 features take the
# tensor-core head kernels, float32 features the CUDA-core ones.
STEP_LAUNCHES = {"bins_head_fwd": 0, "bins_head_bwd": 0, "bins_head_tc_fwd": 1,
                 "bins_head_tc_bwd": 2, "chamfer": 1}
F32_STEP_LAUNCHES = {"bins_head_fwd": 1, "bins_head_bwd": 2, "bins_head_tc_fwd": 0,
                     "bins_head_tc_bwd": 0, "chamfer": 1}
# the head's products at the flagship shape: (16 x 208 x 272 pixels, 128)
# by (128, 256 bins)
HEAD_PIXELS = TRAIN_BATCH * (TRAIN_HW[0] // 2) * (TRAIN_HW[1] // 2)
# the serving head's: a batch-2 flip-TTA forward, 240 x 320 pixels each
SERVING_PIXELS = 2 * (FRAME_HW[0] // 2) * (FRAME_HW[1] // 2)

# The H100's published peaks (SXM, dense): HBM bytes/s, f32 CUDA-core
# instructions/s (67 TFLOP/s counts an FMA as two), bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F32_OPS = F32_FLOPS / 2
BF16_FLOPS = 989e12


def check(ok, message):
    if not ok:
        raise RuntimeError(message)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, from CUDA events around `iters` runs."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_rel(got, want):
    """Largest error over the largest reference value."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def toolchain(build):
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    release = [ln for ln in nvcc.splitlines() if "release" in ln][-1].strip()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    info = {"torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": release,
            "capability": list(torch.cuda.get_device_capability(0)),
            "triton": triton_version, "nvidia_smi": smi,
            "cudnn": torch.backends.cudnn.version(),
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            # the figures of utils/graphs.py need matplotlib, color150.mat scipy
            "matplotlib": importlib.util.find_spec("matplotlib") is not None,
            "scipy": importlib.util.find_spec("scipy") is not None}
    print("toolchain: " + json.dumps(info))
    print(smi)
    return smi


def build_all(build, libraries):
    """Phase 2: one compiler per source (nvcc for .cu, g++ for the host
    .cpp), started together; `libraries` maps each source to the function
    that builds and loads it."""
    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(libraries)) as pool:
        seconds = list(pool.map(timed, libraries.values()))
    for source, s in zip(libraries, seconds):
        print(f"build: {source} in {s:.2f} s (all sources built in parallel)")
        host = source.endswith(".cpp")
        path = build.host_library_path(source) if host else build.library_path(source)
        log = path.with_suffix(".log").read_text().strip()
        print(log)
        if host:
            continue
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
        check(spills and all(n == "0" for n in spills), f"{source}: ptxas reports spills")


def centers_from(widths):
    b = widths.shape[0]
    edges = torch.cumsum(torch.cat([torch.full((b, 1), 1e-3),
                                    (10 - 1e-3) * widths / widths.sum(1, keepdim=True)], 1), 1)
    return edges, 0.5 * (edges[:, 1:] + edges[:, :-1])


def head_inputs(dtype, gen, b=2, hw=(240, 320), n=N_BINS):
    x = torch.randn((b, 128, *hw), generator=gen).to("cuda", dtype)
    weight = (0.1 * torch.randn((n, 128, 1, 1), generator=gen)).cuda()
    bias = (0.1 * torch.randn((n,), generator=gen)).cuda()
    _, centers = centers_from(torch.rand((b, n), generator=gen))
    return x, weight, bias, centers.cuda()


def check_head_forward(bins_head, gen, b, hw, label):
    """The forward kernel against its plain version; returns stats per dtype."""
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = head_inputs(dtype, gen, b, hw)
        want = bins_head.fused_bins_head_reference(*args)
        got = bins_head.fused_bins_head(*args)
        torch.cuda.synchronize()
        err = (got - want).abs()
        abs_err = err.max().item()
        rel_err = (err / want.abs()).max().item()
        tol = KERNEL_TOL[dtype]
        ms = cuda_ms(lambda: bins_head.fused_bins_head(*args))
        plain_ms = cuda_ms(lambda: bins_head.fused_bins_head_reference(*args))
        x = args[0]
        pixels, n = x.shape[0] * x.shape[2] * x.shape[3], args[1].shape[0]
        flops = 2 * pixels * 128 * n
        nbytes = x.numel() * x.element_size() + pixels * 4
        least = bound(flops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS, nbytes)
        with_stats = ""
        if dtype == torch.float32:  # as in training, where a backward follows
            stats_ms = cuda_ms(lambda: bins_head._launch(*args, stats=True))
            with_stats = f" ({stats_ms:.4f} ms writing the softmax stats for a backward)"
        print(f"head forward {label} {dtype}: max_abs_err {abs_err:.3e} max_rel_err "
              f"{rel_err:.3e} (tolerance rtol=atol={tol}) kernel {ms:.4f} ms{with_stats} plain "
              f"{plain_ms:.4f} ms bound {least['bound_ms']:.4f} ms ({least['bound_by']}), "
              f"{100 * least['bound_ms'] / ms:.1f}% of the bound")
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        stats[dtype] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, **least}
    return stats


def bound(work, rate, nbytes):
    """The least time for `work` at `rate` and `nbytes` at the HBM rate."""
    ops_ms, bytes_ms = 1e3 * work / rate, 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def check_head_backward(bins_head, gen):
    """The backward kernels against autograd through the plain version at
    the training shape; returns stats per dtype. The backward kernels of
    both families read the forward's depth and (max, sum), so the forward
    runs once, untimed, first."""
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = head_inputs(dtype, gen, TRAIN_BATCH, (TRAIN_HW[0] // 2, TRAIN_HW[1] // 2))
        upstream = torch.randn((TRAIN_BATCH, 1, *args[0].shape[2:]), generator=gen).cuda()
        inputs = [t.detach().clone().requires_grad_() for t in args]
        plain_out = bins_head.fused_bins_head_reference(*inputs)
        want = torch.autograd.grad(plain_out, inputs, upstream, retain_graph=True)
        if dtype == torch.bfloat16:
            saved = bins_head._launch_tc(*args)
            backward = lambda: bins_head._launch_tc_bwd(*args, upstream, *saved)
        else:
            saved = bins_head._launch(*args, stats=True)
            backward = lambda: bins_head._launch_bwd(*args, upstream, *saved)
        got = backward()
        got = (got[0], got[1].reshape(args[1].shape), got[2], got[3])
        torch.cuda.synchronize()
        errs = {}
        for name, g, r in zip(("dx", "dW", "db", "dcenters"), got, want):
            check(g.shape == r.shape and g.dtype == r.dtype, f"{name}: {g.shape} {g.dtype}")
            errs[name] = ((g.float() - r.float()).abs().max().item(), max_rel(g, r))
        ms = cuda_ms(backward, iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, inputs, upstream,
                                                       retain_graph=True), iters=5, warmup=1)
        tol = GRAD_TOL[dtype]
        x = args[0]
        pixels = x.shape[0] * x.shape[2] * x.shape[3]
        flops = 3 * 2 * pixels * 128 * N_BINS
        nbytes = 2 * x.numel() * x.element_size() + pixels * 4
        least = bound(flops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS, nbytes)
        print(f"head backward {dtype} (B={TRAIN_BATCH}, {args[0].shape[2]}x"
              f"{args[0].shape[3]}, {N_BINS} bins): " + ", ".join(
                  f"{k} max_abs_err {a:.3e} rel {r:.3e}" for k, (a, r) in errs.items())
              + f" (tolerance of the largest value: {tol}) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {least['bound_ms']:.4f} ms ({least['bound_by']}), "
              f"{100 * least['bound_ms'] / ms:.1f}% of the bound")
        for name, (_, rel) in errs.items():
            check(rel <= tol[name], f"head backward {dtype} {name}: {rel:.3e} > {tol[name]}")
        stats[dtype] = {"max_abs_err": max(a for a, _ in errs.values()), "ms": ms,
                        "plain_ms": plain_ms, **least}
        del plain_out, inputs, want, got, backward, saved
    return stats


def check_chunked_head(bins_head, gen):
    """The bf16 tensor-core kernels with W staged through shared memory in
    chunks (1,024 bins) against the plain version at the training pixel
    count. Off the main path, which has 256 bins."""
    hw = (TRAIN_HW[0] // 2, TRAIN_HW[1] // 2)
    args = head_inputs(torch.bfloat16, gen, TRAIN_BATCH, hw, n=CHUNKED_BINS)
    upstream = torch.randn((TRAIN_BATCH, 1, *hw), generator=gen).cuda()
    inputs = [t.detach().clone().requires_grad_() for t in args]
    plain_out = bins_head.fused_bins_head_reference(*inputs)
    want = torch.autograd.grad(plain_out, inputs, upstream)
    out, saved = bins_head._launch_tc(*args)
    got = bins_head._launch_tc_bwd(*args, upstream, out, saved)
    torch.cuda.synchronize()
    tol, grad_tol = KERNEL_TOL[torch.bfloat16], GRAD_TOL[torch.bfloat16]
    abs_err = (out - plain_out.detach()).abs().max().item()
    errs = {name: max_rel(g.reshape(r.shape), r)
            for name, g, r in zip(("dx", "dW", "db", "dcenters"), got, want)}
    fwd_ms = cuda_ms(lambda: bins_head._launch_tc(*args), iters=5, warmup=1)
    bwd_ms = cuda_ms(lambda: bins_head._launch_tc_bwd(*args, upstream, out, saved),
                     iters=5, warmup=1)
    print(f"head bf16, W in chunks (B={TRAIN_BATCH}, {hw[0]}x{hw[1]}, {CHUNKED_BINS} bins): "
          f"forward max_abs_err {abs_err:.3e} (rtol=atol={tol}); backward "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" of the largest value (tolerance {grad_tol}); forward {fwd_ms:.4f} ms, "
          f"backward {bwd_ms:.4f} ms")
    torch.testing.assert_close(out, plain_out.detach(), rtol=tol, atol=tol)
    for name, rel in errs.items():
        check(rel <= grad_tol[name],
              f"chunked head backward {name}: {rel:.3e} > {grad_tol[name]}")


def cublas_yardstick(gen):
    """Two cuBLAS products of the head's sizes as yardsticks of the card's
    rates, which the port never calls (no single PyTorch call computes the
    head): bf16 (905,216 x 128) by (128 x 256), the training head's, on the
    tensor cores; float32 (153,600 x 128) by (128 x 256), the serving
    head's, with TF32 off."""
    for dtype, pixels, rate in ((torch.bfloat16, HEAD_PIXELS, BF16_FLOPS),
                                (torch.float32, SERVING_PIXELS, F32_FLOPS)):
        a = torch.randn((pixels, 128), generator=gen).to("cuda", dtype)
        b = torch.randn((128, N_BINS), generator=gen).to("cuda", dtype)
        ms = cuda_ms(lambda: torch.matmul(a, b))
        flops = 2 * pixels * 128 * N_BINS
        nbytes = a.element_size() * (a.numel() + b.numel() + pixels * N_BINS)
        print(f"yardstick: cuBLAS {dtype} matmul ({pixels} x 128) by (128 x {N_BINS}): "
              f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s (bound "
              f"{bound(flops, rate, nbytes)['bound_ms']:.4f} ms)")
        del a, b


def smooth_depth(b, h, w, gen):
    """A tilted plane per image from 0.5 to 9.5 m in whole millimetres (NYU's
    ground truth is stored in mm), with a block of invalid zeros: neighbouring
    pixels share a depth and a nearest bin (tests/test_torch_port_cuda.py)."""
    a = torch.rand((b, 1, 1), generator=gen)
    y = torch.linspace(0, 1, h)[None, :, None]
    x = torch.linspace(0, 1, w)[None, None, :]
    depth = torch.round(1000 * (0.5 + 9.0 * (a * x + (1 - a) * y))) / 1000
    depth[:, h // 4:h // 4 + 64, w // 3:w // 3 + 128] = 0.0
    return depth[:, None]


def check_chamfer_reductions(chamfer, centers, depth, label):
    """The reductions kernel against its plain version on one depth map;
    returns its stats. The function's work: per (bin, valid pixel) pair one
    squared distance (a subtract and a multiply), then about 4 compares and
    selects for the per-pixel min with its tie count and the per-bin min
    with its depth."""
    flat = depth.reshape(depth.shape[0], -1)
    want = chamfer.chamfer_reductions_reference(centers, flat)
    got = chamfer.chamfer_reductions(centers, flat)
    torch.cuda.synchronize()
    abs_err = 0.0
    for name, g, r in zip(("min", "nearest", "count", "depth_sum", "y_min"), got, want):
        abs_err = max(abs_err, (g - r).abs().max().item())
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6, msg=f"{label} {name}")
    ms = cuda_ms(lambda: chamfer.chamfer_reductions(centers, flat), iters=10)
    plain_ms = cuda_ms(lambda: chamfer.chamfer_reductions_reference(centers, flat),
                       iters=3, warmup=1)
    valid = int((flat >= 1e-3).sum())
    ops = 6 * centers.shape[1] * valid
    nbytes = 2 * flat.numel() * 4 + centers.numel() * 4
    least = bound(ops, F32_OPS, nbytes)
    print(f"chamfer reductions, {label} ({flat.shape[0]} x {TRAIN_HW[0]}x{TRAIN_HW[1]} pixels, "
          f"{valid} valid, {centers.shape[1]} bins): max_abs_err {abs_err:.3e} (rtol 1e-5, "
          f"atol 1e-6); kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
          f"{least['bound_ms']:.4f} ms ({least['bound_by']}), "
          f"{100 * least['bound_ms'] / ms:.1f}% of the bound")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, **least}


def check_chamfer(chamfer, gen):
    """The chamfer kernel against its plain version at the flagship shape,
    on uniform noise (the training step's synthetic GT, and the kernels
    line's row) and on a smooth millimetre-quantized map; the loss and its
    gradient on the noise."""
    from mde_tpu_torch.ops.losses import bins_chamfer_loss
    edges, centers = centers_from(torch.rand((TRAIN_BATCH, N_BINS), generator=gen))
    depth = 0.05 + 9.9 * torch.rand((TRAIN_BATCH, 1, *TRAIN_HW), generator=gen)
    edges, centers, depth = edges.cuda(), centers.cuda(), depth.cuda()
    stats = check_chamfer_reductions(chamfer, centers, depth, "noise")
    # its own generator, so that the later phases draw what they drew before
    smooth = smooth_depth(TRAIN_BATCH, *TRAIN_HW, torch.Generator().manual_seed(SEED + 1))
    check_chamfer_reductions(chamfer, centers, smooth.cuda(), "smooth mm map")

    # loss and gradient: the kernel's entry against the plain chunked loss
    # (value) and against the same entry on the CPU, where it runs the plain
    # reductions with the same tie rule (gradient)
    e = edges.clone().requires_grad_()
    value = chamfer.chamfer_1d(e, depth)
    value.backward()
    plain_value = bins_chamfer_loss(edges, depth)
    e_cpu = edges.cpu().requires_grad_()
    cpu_value = chamfer.chamfer_1d(e_cpu, depth.cpu())
    cpu_value.backward()
    grad_rel = max_rel(e.grad.cpu(), e_cpu.grad)
    print(f"chamfer loss ({TRAIN_BATCH} x {TRAIN_HW[0]}x{TRAIN_HW[1]} pixels, {N_BINS} bins, "
          f"noise): kernel {value.item():.7e} plain {plain_value.item():.7e} (rtol 1e-5); "
          f"gradient to the edges vs the CPU plain reductions {grad_rel:.3e} of the largest "
          f"value (tolerance 1e-4)")
    torch.testing.assert_close(value, plain_value, rtol=1e-5, atol=1e-7)
    check(grad_rel <= 1e-4, f"chamfer gradient {grad_rel:.3e} > 1e-4")
    return stats


def seeded_state_dict(model, gen):
    """Random weights from a torch.Generator: lecun-scale kernels, small
    biases, BN running stats mean +-0.1 and var 0.5-1.5."""
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = t
        elif name.endswith("running_mean"):
            sd[name] = 0.2 * torch.rand(t.shape, generator=gen) - 0.1
        elif name.endswith("running_var"):
            sd[name] = 0.5 + torch.rand(t.shape, generator=gen)
        elif name.endswith("positional_encodings"):
            sd[name] = torch.rand(t.shape, generator=gen)
        elif t.dim() > 1:
            sd[name] = torch.randn(t.shape, generator=gen) / (t[0].numel() ** 0.5)
        elif name.endswith("weight"):
            sd[name] = 1 + 0.1 * torch.randn(t.shape, generator=gen)
        else:
            sd[name] = 0.1 * torch.randn(t.shape, generator=gen)
    return sd


def serve(bins_head, gen, profile_dir):
    """Phase 4: the serving path; returns the kernel launches of its run."""
    from mde_tpu_torch.data.transforms import normalize_image
    from mde_tpu_torch.infer import InferenceHelper
    from mde_tpu_torch.models import UnetAdaptiveBins

    shell = UnetAdaptiveBins(n_bins=N_BINS, min_val=1e-3, max_val=10.0,
                             encoder_name="efficientnet-b1")
    helper = InferenceHelper(dataset="nyu", n_bins=N_BINS, encoder_name="efficientnet-b1",
                             state_dict=seeded_state_dict(shell, gen),
                             device=torch.device("cuda"))
    rng = np.random.default_rng(SEED)
    frames = [normalize_image(rng.random((*FRAME_HW, 3), dtype=np.float32))[None]
              for _ in range(REQUESTS)]
    for frame in frames[:2]:  # warm-up: cuDNN heuristics, allocator
        helper.predict(frame)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    latencies, outputs = [], []
    for frame in frames:
        t0 = time.perf_counter()
        outputs.append(helper.predict(frame))  # ends in a device->host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: {REQUESTS} requests of {FRAME_HW[0]}x{FRAME_HW[1]}, kernel launches "
          f"{counts['bins_head_fwd']}, median latency {statistics.median(latencies):.3f} ms "
          f"(all: {', '.join(f'{v:.3f}' for v in latencies)}), "
          f"max_memory_allocated {peak} bytes")
    check(counts == {**{k: 0 for k in counts}, "bins_head_fwd": REQUESTS},
          f"serving launches {counts} for {REQUESTS} requests")
    for centers, depth in outputs:
        check(depth.shape == (1, *FRAME_HW, 1), f"depth shape {depth.shape}")
        check(np.isfinite(depth).all() and depth.min() >= 1e-3 and depth.max() <= 10.0,
              "depth not finite or outside [1e-3, 10] m")
        check(centers.ndim == 1 and centers.size > 0, "no bin centers in range")

    helper.model.fused_head = False  # the same model on the plain head
    _, plain = helper.predict(frames[0])
    helper.model.fused_head = True
    head_err = float(np.abs(outputs[0][1] - plain).max())
    print(f"serve: fused vs plain head on request 0: max_abs_err {head_err:.3e} m "
          f"(tolerance atol {HEAD_TOL} m, rtol 1e-5); depth range "
          f"{outputs[0][1].min():.4f}-{outputs[0][1].max():.4f} m")
    np.testing.assert_allclose(outputs[0][1], plain, rtol=1e-5, atol=HEAD_TOL)

    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    tf32_ms = statistics.median(request_ms(helper, frames))
    print(f"serve: with cuDNN TF32 on, median latency {tf32_ms:.3f} ms, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    torch.backends.cudnn.allow_tf32 = False

    if profile_dir is not None:
        profile(helper, frames, Path(profile_dir))
    del helper
    return counts


def request_ms(helper, frames):
    """Host-clock latency of each request after one warm-up request."""
    helper.predict(frames[0])
    out = []
    for frame in frames:
        t0 = time.perf_counter()
        helper.predict(frame)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_busy_us(prof):
    """Union of the device's kernel intervals in a profile, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us, len(spans)


def profile(helper, frames, out_dir):
    """For cuDNN TF32 off and on, and for cudnn.benchmark: the median request
    latency, device time by kernel and by op input shape over 2 requests, and
    the device's busy share (the union of kernel intervals over the wall)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    out_dir.mkdir(parents=True, exist_ok=True)
    for tf32, bench in ((False, False), (True, False), (False, True), (True, True)):
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = tf32, bench
        tag = f"tf32_{int(tf32)}_benchmark_{int(bench)}"
        median = statistics.median(request_ms(helper, frames))
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           record_shapes=True) as prof:
            t0 = time.perf_counter()
            for frame in frames[:2]:
                helper.predict(frame)
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, n_events = device_busy_us(prof)
        by_kernel = prof.key_averages().table(sort_by="self_device_time_total",
                                              row_limit=25, max_name_column_width=90)
        by_shape = prof.key_averages(group_by_input_shape=True).table(
            sort_by="device_time_total", row_limit=25, max_name_column_width=40,
            max_shapes_column_width=100)
        (out_dir / f"chip_smoke_profile_{tag}.txt").write_text(by_kernel + "\n" + by_shape)
        print(f"profile {tag}: median request {median:.3f} ms; over 2 requests wall "
              f"{wall_us:.0f} us, device busy {busy_us:.0f} us "
              f"({100 * busy_us / wall_us:.1f}%), {n_events} device events")
        print(by_kernel)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = False, False


def flagship_args(**kw):
    """The flagship training configuration of bench.py and __graft_entry__.py."""
    import types
    base = dict(n_bins=N_BINS, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b1", use_semantics=None,
                use_instance_segmentation=None, insertion_point="before-attn", image="rgb",
                w_chamfer=0.1, chamfer=True, dataset="nyu", min_depth_eval=1e-3,
                max_depth_eval=10.0, eigen_crop=True, garg_crop=False,
                epochs=25, lr=0.000357, wd=0.1, div_factor=25.0, final_div_factor=100.0,
                same_lr=False, encoder_lr_factor=1.0, seed=SEED, use_fused_head=True,
                use_pallas_chamfer=True,
                compute_dtype="bfloat16", accum_steps=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


def reset_counts():
    from mde_tpu_torch.kernels import bins_head, chamfer
    bins_head.LAUNCHES = bins_head.BWD_LAUNCHES = chamfer.LAUNCHES = 0
    bins_head.TC_LAUNCHES = bins_head.TC_BWD_LAUNCHES = 0


def read_counts():
    from mde_tpu_torch.kernels import bins_head, chamfer
    return {"bins_head_fwd": bins_head.LAUNCHES, "bins_head_bwd": bins_head.BWD_LAUNCHES,
            "bins_head_tc_fwd": bins_head.TC_LAUNCHES,
            "bins_head_tc_bwd": bins_head.TC_BWD_LAUNCHES, "chamfer": chamfer.LAUNCHES}


def synthetic_cues(n, hw, inst_mode, gen):
    """Raw cue maps (N, 1, H, W) as the loaders give them: semantic labels
    uniform in [0, 150); instance labels as four rectangular blocks on the
    background class (ade20k_swin 0-100, background 100; coco 0-80,
    background 0), areas each block's pixel count (0 on the background)."""
    h, w = hw
    coco = inst_mode == "coco"
    background, n_classes = (0, 81) if coco else (100, 101)

    def draw(lo, hi):
        return int(torch.randint(lo, hi, (1,), generator=gen))

    labels = torch.full((n, 1, h, w), background, dtype=torch.int32)
    areas = torch.zeros((n, 1, h, w))
    for i in range(n):
        block = torch.zeros((h, w), dtype=torch.long)
        for b in range(1, 5):
            y0, x0 = draw(0, h // 2), draw(0, w // 2)
            y1, x1 = y0 + draw(h // 8, h // 2), x0 + draw(w // 8, w // 2)
            labels[i, 0, y0:y1, x0:x1] = draw(1 if coco else 0, n_classes - 1)
            block[y0:y1, x0:x1] = b
        counts = torch.bincount(block.flatten(), minlength=5)
        counts[0] = 0
        areas[i, 0] = counts[block].float()
    return {"semantics": torch.randint(0, 150, (n, 1, h, w), generator=gen,
                                       dtype=torch.int32),
            "instance_labels": labels, "instance_areas": areas}


def train_batch(args, gen, n, hw):
    """Image N(0,1), depth U(0.05, 9.95) m, and the raw cue maps the
    configuration reads, on the card."""
    batch = {"image": torch.randn((n, 3, *hw), generator=gen),
             "depth": 0.05 + 9.9 * torch.rand((n, 1, *hw), generator=gen)}
    if args.use_semantics or args.use_instance_segmentation:
        batch.update(synthetic_cues(n, hw, args.use_instance_segmentation, gen))
    return {k: v.cuda() for k, v in batch.items()}


def cue_embedders(args, device="cuda"):
    from mde_tpu_torch.cues import InstanceEmbedder, SemanticsEmbedder
    return SemanticsEmbedder(args, device), InstanceEmbedder(args, device)


def seeded_model(args, gen):
    """The configuration's model on the card with seeded random weights."""
    from mde_tpu_torch.models import build_model
    model = build_model(args)
    model.load_state_dict(seeded_state_dict(model, gen), strict=True)
    return model.cuda()


def train(args, model, gen, profile_dir, label):
    """The flagship training step on `model`, with the configuration's cue
    embedders; returns (launches per kernel over the timed steps, median step
    ms, peak bytes)."""
    from mde_tpu_torch.train import create_train_state, make_train_step

    embedders = cue_embedders(args)
    state = create_train_state(model, args, steps_per_epoch=2693)
    step = make_train_step(args, *embedders)
    batch = train_batch(args, gen, TRAIN_BATCH, TRAIN_HW)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}

    for _ in range(WARMUP_STEPS):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, metrics, per_step = [], [], []
    reset_counts()
    for _ in range(TIMED_STEPS):
        counts = read_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
        per_step.append({k: v - counts[k] for k, v in read_counts().items()})
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(step_ms)
    print(f"{label}: {TIMED_STEPS} steps after {WARMUP_STEPS} warm-up, batch {TRAIN_BATCH} of "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16 autocast: median step {median:.3f} ms "
          f"(all: {', '.join(f'{v:.3f}' for v in step_ms)}), "
          f"{1e3 * TRAIN_BATCH / median:.2f} images/s, max_memory_allocated {peak} bytes")
    for i, m in enumerate(metrics):
        print(f"{label}: step {WARMUP_STEPS + i}: loss {m['loss'].item():.6f} silog "
              f"{m['silog'].item():.6f} chamfer {m['chamfer'].item():.6f} launches "
              f"{per_step[i]}")
        check(all(np.isfinite(v.item()) for v in m.values()), f"step {i}: metric not finite")
        check(per_step[i] == STEP_LAUNCHES,
              f"{label} step {i}: launches {per_step[i]}, expected {STEP_LAUNCHES}")
    changed = sum(not torch.equal(p.detach(), before[k]) for k, p in model.named_parameters())
    cue_mlps = sorted({k.split(".")[0] for k in before if k.startswith(CUE_MLP_PREFIXES)})
    print(f"{label}: {changed} of {len(before)} parameter tensors changed (stem "
          f"{tuple(model.encoder.original_model.conv_stem.weight.shape)}, CueMLPs "
          f"{cue_mlps}); step count {state.step}")
    check(changed == len(before), "some parameters did not change")

    share = train_kernel_share(step, state, batch, profile_dir, label)
    print(f"{label}: profile over 2 steps: {share}")
    if profile_dir is not None and cue_mlps:
        print(f"{label}: {cue_share(args, state, batch)}")
    del state, before
    return launches, median, peak


def cue_share(args, state, batch):
    """Device time per step of the cue ops, over 2 profiled steps: the
    embedders (a record_function range each), and the forward and backward
    convolutions of the CueMLPs and of the cue-widened stem, found by their
    weight shapes. The concatenations and the CueMLPs' ReLUs are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function
    from mde_tpu_torch.train import make_train_step

    def annotated(fn, name):
        def call(*a):
            with record_function(name):
                return fn(*a)
        return call

    sem, inst = cue_embedders(args)
    step = make_train_step(args, annotated(sem, "cues.semantics"),
                           annotated(inst, "cues.instances"))
    model = state.model
    stem = tuple(model.encoder.original_model.conv_stem.weight.shape)
    weights = {stem: "stem"}
    for name, m in model.named_modules():
        if name.split(".")[0] + "." in CUE_MLP_PREFIXES and isinstance(m, torch.nn.Conv2d):
            weights[tuple(m.weight.shape)] = "CueMLPs"
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in device_events(prof))
    parts = {"embedders": 0.0, "stem": 0.0, "CueMLPs": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in ("cues.semantics", "cues.instances"):
            parts["embedders"] += e.device_time_total
        elif e.name in ("aten::convolution", "aten::convolution_backward"):
            hit = [weights[tuple(sh)] for sh in e.input_shapes if tuple(sh) in weights]
            if hit:
                parts[hit[0]] += e.device_time_total
    if total == 0:
        return "cue ops: no device time in the profile, not measured"
    return ("cue ops, device time per step: " + ", ".join(
        f"{k} {v / 2e3:.3f} ms ({100 * v / total:.2f}%)" for k, v in parts.items())
        + f" (stem weight {stem}); together {sum(parts.values()) / 2e3:.3f} ms, "
        f"{100 * sum(parts.values()) / total:.2f}% of {total / 2e3:.3f} ms of device time")


def train_kernel_share(step, state, batch, profile_dir, label):
    """Device time of the port's kernels against all device time, over 2
    profiled steps, and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, n_events = device_busy_us(prof)
    events = device_events(prof)
    total = sum(e.time_range.elapsed_us() for e in events)
    ours = {name: sum(e.time_range.elapsed_us() for e in events if name in e.name)
            for name in ("bins_head_fwd_kernel", "bins_head_bwd_pixel_kernel",
                         "bins_head_bwd_weight_kernel", "bins_head_tc_fwd_kernel",
                         "bins_head_tc_bwd_pixel_kernel", "bins_head_tc_bwd_weight_kernel",
                         "chamfer_kernel")}
    if profile_dir is not None:
        out = Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"chip_smoke_profile_{label}.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40, max_name_column_width=90))
    if total == 0:
        return "no device time in the profile: kernel share not measured"
    return (f"device time (sum of device events) {total / 2e3:.3f} ms per step; "
            + ", ".join(f"{k} {v / 2e3:.3f} ms ({100 * v / total:.1f}%)"
                        for k, v in ours.items())
            + f"; the port's kernels {100 * sum(ours.values()) / total:.1f}%; wall "
            f"{wall_us / 2e3:.3f} ms per step (profiled), device busy "
            f"{100 * busy_us / wall_us:.1f}%, {n_events} device events")


def step_against_plain(state_dict, gen, dtype, cue=None):
    """Phase 6: one step at batch 2 through the kernels and through the
    unfused head and the plain chamfer, on the same weights and batch, in
    float32 or under bf16 autocast, in the flagship configuration or the cue
    configuration `cue`; returns the kernel run's launches."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import make_loss_fn

    config = CUE_CONFIGS.get(cue, {})
    batch = train_batch(flagship_args(**config), gen, 2, TRAIN_HW)
    label = ("float32" if dtype == torch.float32 else "bf16 autocast") + (
        f", config {cue}" if cue else "")
    tol = STEP_TOL[dtype]
    results = {}
    for kernels in (True, False):
        args = flagship_args(compute_dtype="float32" if dtype == torch.float32 else "bfloat16",
                             use_fused_head=kernels, use_pallas_chamfer=kernels, **config)
        model = build_model(args).cuda().train()
        model.load_state_dict(state_dict, strict=True)
        loss_fn = make_loss_fn(args, *cue_embedders(args))
        generator = torch.Generator(device="cuda").manual_seed(SEED)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, l_dense, l_chamfer = loss_fn(model, batch, generator)
        loss.backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                 if k.startswith(("conv_out.", "adaptive_bins_layer.regressor.")
                                 + CUE_MLP_PREFIXES)}
        results[kernels] = (loss.item(), l_dense.item(), l_chamfer.item(), grads, counts)
        print(f"step check {label}, {'kernels' if kernels else 'plain'}: loss {loss.item():.7f} "
              f"silog {l_dense.item():.7f} chamfer {l_chamfer.item():.7e}, launches {counts}, "
              f"{seconds:.2f} s, max_memory_allocated {torch.cuda.max_memory_allocated()} "
              f"bytes")
        want = F32_STEP_LAUNCHES if dtype == torch.float32 else STEP_LAUNCHES
        want = want if kernels else {k: 0 for k in want}
        check(counts == want, f"step check {label} launches {counts}, expected {want}")
        del model, loss
    kern, plain = results[True], results[False]
    for name, a, b in zip(("loss", "silog", "chamfer"), kern[:3], plain[:3]):
        check(abs(a - b) <= tol * abs(b), f"step check {label} {name}: {a} vs {b}")
    errs = {k: max_rel(kern[3][k], plain[3][k]) for k in plain[3]}
    worst = max((e, k) for k, e in errs.items())
    cue_worst = max((e for k, e in errs.items() if k.startswith(CUE_MLP_PREFIXES)),
                    default=None)
    print(f"step check {label}: loss, silog, chamfer within rtol {tol}; largest gradient "
          f"error {worst[0]:.3e} of the largest value ({worst[1]}; tolerance {tol}) over "
          f"{len(errs)} tensors" + ("" if cue_worst is None else
                                    f"; CueMLPs' largest {cue_worst:.3e}"))
    check(worst[0] <= tol, f"step check {label} gradient {worst}")
    return kern[4]


def check_embedders(gen):
    """The cue embedders of A, B and C on the card against the same
    embedders on the CPU, on labels in [-200, 200) with -1 and values past
    every table: gathers and area maps equal, NaN in the same places, and no
    device-side assert (the synchronize would raise it)."""
    shape = (2, 1, *FRAME_HW)
    labels = torch.randint(-200, 200, shape, generator=gen, dtype=torch.int32)
    labels.view(-1)[:4] = torch.tensor([-1, 150, -151, 1000], dtype=torch.int32)
    areas = torch.randint(0, 5000, shape, generator=gen).float()
    for name in ("A", "B"):  # C embeds as A does
        args = flagship_args(**CUE_CONFIGS[name])
        (sem_gpu, inst_gpu), (sem_cpu, inst_cpu) = cue_embedders(args), cue_embedders(args, "cpu")
        got = [*sem_gpu(labels.cuda()), *inst_gpu(labels.cuda(), areas.cuda())]
        torch.cuda.synchronize()
        want = [*sem_cpu(labels), *inst_cpu(labels, areas)]
        names = ("semantics raw", "semantics", "instance raw", "instance labels",
                 "instance areas")
        nans = []
        for what, g, w in zip(names, got, want):
            g = g.cpu()
            check(g.shape == w.shape and g.dtype == w.dtype, f"{name} {what}: {g.shape}")
            check(torch.equal(g.isnan(), w.isnan()) if g.is_floating_point() else True,
                  f"{name} {what}: NaN in other places on the card")
            check(torch.equal(torch.nan_to_num(g, 7.0), torch.nan_to_num(w, 7.0))
                  if g.is_floating_point() else torch.equal(g, w),
                  f"{name} {what}: card and CPU differ")
            nans.append(int(g.isnan().sum()) if g.is_floating_point() else 0)
        print(f"embedders {name} ({args.use_semantics}, {args.use_instance_segmentation}) on "
              f"{shape}: card equals CPU in every channel; NaN values per output "
              f"{dict(zip(names, nans))}; no device-side assert")


def eval_frames(args, gen):
    """EVAL_FRAMES host batches of one 480x640 frame: image N(0,1), depth
    U(0.05, 9.95) m with a block of zeros, and the configuration's raw cues
    if it has any."""
    frames = []
    for _ in range(EVAL_FRAMES):
        depth = 0.05 + 9.9 * torch.rand((1, 1, *FRAME_HW), generator=gen)
        depth[:, :, 100:180, 200:330] = 0.0
        frames.append({"image": torch.randn((1, 3, *FRAME_HW), generator=gen), "depth": depth})
        if args.use_semantics or args.use_instance_segmentation:
            frames[-1].update(synthetic_cues(1, FRAME_HW, args.use_instance_segmentation, gen))
    return frames


def run_validate(args, model, frames):
    """validate over the frames, each step timed to its end and its
    outputs, and each forward's prediction, kept; returns (metrics, val
    SILog, per-frame (ms, silog, metrics), predictions)."""
    from mde_tpu_torch.train import make_eval_step, validate
    eval_step = make_eval_step(args, *cue_embedders(args))
    steps, preds = [], []

    def timed(*a):
        t0 = time.perf_counter()
        out = eval_step(*a)
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t0) * 1e3, *out[:2]))
        return out

    hook = model.register_forward_hook(lambda m, i, out: preds.append(out[1].clone()))
    try:
        vals, val_si = validate(args, timed, model, frames)
    finally:
        hook.remove()
    return vals, val_si, steps, preds


def evaluate(name, gen, profile_dir):
    """Phase 7: configuration `name` (or the no-cue flagship model, "no
    cues") through make_eval_step + validate; returns (the launches of the
    timed run, the median ms a frame)."""
    from mde_tpu_torch.ops import METRIC_NAMES, compute_errors, eval_mask
    from mde_tpu_torch.ops.resize import resize_bilinear_align_corners

    args = flagship_args(compute_dtype="float32", **CUE_CONFIGS.get(name, {}))
    model = seeded_model(args, gen)
    frames = eval_frames(args, gen)
    run_validate(args, model, frames[:2])  # warm-up: cuDNN heuristics, allocator
    reset_counts()
    vals, val_si, steps, preds = run_validate(args, model, frames)
    counts = read_counts()
    median = statistics.median(ms for ms, _, _ in steps)
    print(f"eval {name}: {EVAL_FRAMES} frames of {FRAME_HW[0]}x{FRAME_HW[1]}, batch 1, "
          f"float32: median {median:.3f} ms a frame (all: "
          f"{', '.join(f'{ms:.3f}' for ms, _, _ in steps)}); launches {counts}; val silog "
          f"{val_si.get_value():.6f}; metrics " + json.dumps(vals))
    check(counts == {**{k: 0 for k in counts}, "bins_head_fwd": EVAL_FRAMES},
          f"eval {name}: launches {counts} for {EVAL_FRAMES} frames")
    check(val_si.count == EVAL_FRAMES and all(np.isfinite(v) for v in vals.values())
          and np.isfinite(val_si.get_value()), f"eval {name}: a metric is not finite")
    if profile_dir is not None:
        print(f"eval {name}: {eval_profile(args, model, frames, Path(profile_dir), name)}")

    model.fused_head = False  # the same steps through the plain head
    reset_counts()
    _, _, plain_steps, plain_preds = run_validate(args, model, frames)
    check(read_counts() == {k: 0 for k in counts}, f"eval {name}: the plain head launched")
    model.fused_head = True
    head_err = max((a - b).abs().max().item() for a, b in zip(preds, plain_preds))
    for a, b in zip(preds, plain_preds):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=HEAD_TOL)

    # the card's masked metrics against float64 compute_errors on the host,
    # over the same resized, clamped prediction
    crop = torch.from_numpy(eval_mask(FRAME_HW, "nyu", False, True))
    metric_err = 0.0
    for frame, pred, (_, _, got) in zip(frames, preds, steps):
        gt = frame["depth"][0, 0]
        p = resize_bilinear_align_corners(pred.float(), FRAME_HW)
        p = torch.clamp(p, args.min_depth_eval, args.max_depth_eval).cpu()[0, 0]
        valid = (gt > args.min_depth_eval) & (gt < args.max_depth_eval) & crop
        want = compute_errors(gt[valid].double().numpy(), p[valid].double().numpy())
        for k in METRIC_NAMES:
            err = abs(got[k].item() - want[k]) / abs(want[k])
            metric_err = max(metric_err, err)
            check(err <= METRIC_TOL, f"eval {name} {k}: card {got[k].item()} vs host {want[k]}")
    plain_ms = statistics.median(ms for ms, _, _ in plain_steps)
    print(f"eval {name}: fused vs plain head, largest depth difference {head_err:.3e} m "
          f"(tolerance atol {HEAD_TOL} m, rtol 1e-5); card metrics vs float64 host "
          f"compute_errors, largest relative difference {metric_err:.3e} (tolerance "
          f"{METRIC_TOL}); plain-head median {plain_ms:.3f} ms a frame")
    del model
    return counts, median


def eval_profile(args, model, frames, out_dir, name):
    """Device time a frame over 4 profiled eval frames, the device's busy
    share of the wall, and the table by op (written to out_dir)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_validate(args, model, frames[:4])
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, n_events = device_busy_us(prof)
    total = sum(e.time_range.elapsed_us() for e in device_events(prof))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"chip_smoke_profile_eval_{name.replace(' ', '_')}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=30,
                                  max_name_column_width=90))
    return (f"profile over 4 frames: device time {total / 4e3:.3f} ms a frame, wall "
            f"{wall_us / 4e3:.3f} ms a frame (profiled), device busy "
            f"{100 * busy_us / wall_us:.1f}%, {n_events / 4:.0f} device events a frame")


def no_adabins(gen):
    """Phase 7, configuration C: one training step at batch 16 and one eval
    frame, finite, with no kernel launched; returns the launches."""
    from mde_tpu_torch.train import create_train_state, make_train_step

    args = flagship_args(**CUE_CONFIGS["C"])
    model = seeded_model(args, gen)
    state = create_train_state(model, args, steps_per_epoch=2693)
    batch = train_batch(args, gen, TRAIN_BATCH, TRAIN_HW)
    reset_counts()
    t0 = time.perf_counter()
    state, m = make_train_step(args, *cue_embedders(args))(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    eval_args = flagship_args(compute_dtype="float32", **CUE_CONFIGS["C"])
    vals, val_si, _, preds = run_validate(eval_args, model, eval_frames(eval_args, gen)[:1])
    counts = read_counts()
    print(f"noAdaBins (C): one step at batch {TRAIN_BATCH} of {TRAIN_HW[0]}x{TRAIN_HW[1]} in "
          f"{step_s:.2f} s (first step, cuDNN heuristics included): loss {m['loss'].item():.6f} "
          f"silog {m['silog'].item():.6f} chamfer {m['chamfer'].item():.6f}; one eval frame: "
          f"depth {tuple(preds[0].shape)} in {preds[0].min().item():.4f}-"
          f"{preds[0].max().item():.4f} m, val silog {val_si.get_value():.6f}, metrics "
          + json.dumps(vals) + f"; launches {counts}")
    check(all(np.isfinite(v.item()) for v in m.values()), "noAdaBins step not finite")
    check(m["chamfer"].item() == 0.0, "noAdaBins step computed a chamfer")
    check(torch.isfinite(preds[0]).all().item() and all(np.isfinite(v) for v in vals.values()),
          "noAdaBins eval not finite")
    check(all(v == 0 for v in counts.values()), f"noAdaBins launched kernels: {counts}")
    del state, model
    return counts


# --- phase 8: the train CLI --------------------------------------------------

REPO = Path(__file__).resolve().parent
CLASSROOM = REPO / "test_imgs" / "classroom__rgb_00283.jpg"
# SHA-256 of PIL's decode of CLASSROOM, (480, 640, 3) uint8 bytes; pinned by
# tests/test_torch_port_data.py on a machine with PIL (this one has none)
CLASSROOM_SHA256 = "fc05530ffb6b5028a13461478c4a7a6af573e4c652eb3304c516b1bd02bef062"
PARAMS_FILE = "params/args_train_nyu_efficientnet-b1.txt"
CLI_TRAIN_FRAMES, CLI_EVAL_FRAMES = 128, 16
CLI_STEPS, CLI_RESUME_STEPS, CLI_VALIDATE_EVERY, CLI_EPOCHS = 12, 14, 6, 2
CLI_STEPS_PER_EPOCH = CLI_TRAIN_FRAMES // TRAIN_BATCH
CLI_PROFILE_STEPS = (3, 8)  # update indices profiled under --profile


def write_png16(path, depth):
    """(H, W) uint16 as a 16-bit grayscale PNG: filter 0 rows, one zlib IDAT."""
    h, w = depth.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          depth.astype(">u2").view(np.uint8).reshape(h, 2 * w)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                     + chunk(b"IEND", b""))


def nyu_tree(root):
    """The NYU-format tree: CLI_TRAIN_FRAMES + CLI_EVAL_FRAMES copies of
    CLASSROOM, each with a smooth millimetre depth map of its own (two
    sinusoids, 500-9,000 mm) as a 16-bit PNG, and the two split files."""
    scene = root / "classroom_0001"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:FRAME_HW[0], 0:FRAME_HW[1]]
    lines = []
    for i in range(CLI_TRAIN_FRAMES + CLI_EVAL_FRAMES):
        fy, fx, py, px = rng.uniform(0.5, 2.0, 2).tolist() + rng.uniform(0, 1, 2).tolist()
        wave = (0.5 + 0.25 * np.sin(2 * np.pi * (fy * yy / FRAME_HW[0] + py))
                + 0.25 * np.cos(2 * np.pi * (fx * xx / FRAME_HW[1] + px)))
        shutil.copyfile(CLASSROOM, scene / f"rgb_{i:05d}.jpg")
        write_png16(scene / f"sync_depth_{i:05d}.png", np.rint(500 + 8500 * wave).astype(np.uint16))
        lines.append(f"/classroom_0001/rgb_{i:05d}.jpg /classroom_0001/sync_depth_{i:05d}.png "
                     "518.8579")
    (root / "train.txt").write_text("\n".join(lines[:CLI_TRAIN_FRAMES]) + "\n")
    (root / "eval.txt").write_text("\n".join(lines[CLI_TRAIN_FRAMES:]) + "\n")


def driver_cadence(first_step, max_steps):
    """(tag, step) of every scalar mde_tpu/train/driver.py's epoch loop and
    `bookkeep` write from `first_step` to `max_steps`, figures aside."""
    from mde_tpu_torch.ops import METRIC_NAMES
    out, step = [("Epoch", first_step)], first_step
    while True:
        if step % 5 == 0:
            out += [("Train/Loss", step), ("Train/SILog", step), ("Train/ChamferLoss", step)]
        step += 1
        if step % CLI_VALIDATE_EVERY == 0 or step >= max_steps:
            out += [("Test/SILog", step)] + [(f"Metrics/{k}", step) for k in METRIC_NAMES]
        if step >= max_steps:
            return out
        if step % CLI_STEPS_PER_EPOCH == 0:
            out.append(("Epoch", step))


class DriverProbe:
    """Wraps the driver's train step, `validate` and `save_checkpoint` for
    the run: each step synchronized and stamped (its update index, the host
    clock at its end), each validation and save timed, the saved bytes
    read; with a profiler, the steps CLI_PROFILE_STEPS profiled."""

    def __init__(self, driver, profile):
        self.driver, self.profile = driver, profile
        self.stamps, self.validations, self.saves = [], [], []
        self.prof = self.prof_wall_us = None
        self.real = {k: getattr(driver, k) for k in ("make_train_step", "validate",
                                                     "save_checkpoint")}

    def __enter__(self):
        def make_train_step(*a, **k):
            step = self.real["make_train_step"](*a, **k)

            def timed(state, batch):
                index = state.step
                if self.profile and index == CLI_PROFILE_STEPS[0]:
                    self._start_profile()
                out = step(state, batch)
                torch.cuda.synchronize()
                self.stamps.append((index, time.perf_counter()))
                if self.profile and index == CLI_PROFILE_STEPS[1]:
                    self.prof_wall_us = (time.perf_counter() - self.prof_t0) * 1e6
                    self.prof.stop()  # collecting the trace falls in the next interval
                return out
            return timed

        def validate(*a, **k):
            t0 = time.perf_counter()
            vals, val_si = self.real["validate"](*a, **k)
            torch.cuda.synchronize()
            self.validations.append(((time.perf_counter() - t0) * 1e3, val_si.count))
            return vals, val_si

        def save_checkpoint(*a, **k):
            t0 = time.perf_counter()
            path = self.real["save_checkpoint"](*a, **k)
            self.saves.append(((time.perf_counter() - t0) * 1e3, os.path.getsize(path)))
            return path

        for name, fn in (("make_train_step", make_train_step), ("validate", validate),
                         ("save_checkpoint", save_checkpoint)):
            setattr(self.driver, name, fn)
        return self

    def _start_profile(self):
        # the device's activity only: a CPU trace of every op of the
        # training thread, the prefetcher and the loader's threads costs
        # the host more than the steps do
        from torch.profiler import ProfilerActivity, profile as torch_profile
        torch.cuda.synchronize()
        self.prof = torch_profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.prof_t0 = time.perf_counter()

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.driver, name, fn)

    def step_ms(self, first, last, skip):
        """The wall of each step from the end of the one before (the loader's
        wait, the step and the previous step's bookkeeping), for update
        indices first..last, less those whose interval holds a validation."""
        ends = dict(self.stamps)
        return {i: (ends[i] - ends[i - 1]) * 1e3 for i in range(first, last + 1)
                if i - 1 in ends and i not in skip}


def loader_batch_ms(args):
    """One batch of TRAIN_BATCH from the train loader alone (the native
    engine: decode, crop, augment with args.num_threads threads), first and
    second batch of an epoch."""
    from mde_tpu_torch.data import DepthDataLoader
    loader = DepthDataLoader(args, "train")
    loader.set_epoch(0)
    it = iter(loader)
    out = []
    for _ in range(2):
        t0 = time.perf_counter()
        batch = next(it)
        out.append((time.perf_counter() - t0) * 1e3)
    check(batch["image"].shape == (TRAIN_BATCH, *TRAIN_HW, 3), "loader batch shape")
    it.close()
    return out


def loader_contention(args, state, steps=6):
    """The driver's train step on one device-resident batch of the loader's,
    synchronized: median ms alone, and while a thread iterates the train
    loader (decode and augment of batches nobody reads) as the prefetcher
    does during a run. Their difference is what the loader's host work
    costs the step's launch thread."""
    import threading
    from mde_tpu_torch.data import DepthDataLoader, DevicePrefetcher
    from mde_tpu_torch.data.prefetch import ARRAY_KEYS
    from mde_tpu_torch.train import make_train_step

    loader = DepthDataLoader(args, "train")
    batch = next(iter(DevicePrefetcher(loader, args.device)))
    batch = {k: v for k, v in batch.items() if k in ARRAY_KEYS}
    step = make_train_step(args)

    def median_ms():
        nonlocal state
        state, _ = step(state, batch)  # warm-up
        torch.cuda.synchronize()
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    alone = median_ms()
    stop = threading.Event()

    def drain():
        epoch = 0
        while not stop.is_set():
            loader.set_epoch(epoch)
            for _ in loader:
                if stop.is_set():
                    return
            epoch += 1

    thread = threading.Thread(target=drain, daemon=True)
    thread.start()
    try:
        busy = median_ms()
    finally:
        stop.set()
        thread.join()
    return alone, busy


def cli_argv(root, params_file=PARAMS_FILE):
    """The phase-8 tree's paths, with the flagship's batch and cadence."""
    data = str(root / "nyu")
    return [params_file, "--bs", str(TRAIN_BATCH), "--epochs", str(CLI_EPOCHS),
            "--validate_every", str(CLI_VALIDATE_EVERY), "--root", str(root / "runs"),
            "--data_path", data, "--gt_path", data,
            "--filenames_file", str(root / "nyu" / "train.txt"),
            "--data_path_eval", data, "--gt_path_eval", data,
            "--filenames_file_eval", str(root / "nyu" / "eval.txt")]


def train_cli(root, profile_dir, synthetic_ms):
    """Phase 8 on the tree under `root`; returns the launches of the two
    driver runs."""
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.data import read_rgb
    from mde_tpu_torch.train import driver, onecycle_lr_schedule

    decoded = read_rgb(CLASSROOM)
    digest = hashlib.sha256(decoded.tobytes()).hexdigest()
    print(f"train CLI: decode of {CLASSROOM.name}: {decoded.shape} {decoded.dtype}, "
          f"sha256 {digest}")
    check(digest == CLASSROOM_SHA256, "the port's JPEG decode differs from PIL's")

    t0 = time.perf_counter()
    nyu_tree(root / "nyu")
    print(f"train CLI: tree of {CLI_TRAIN_FRAMES} + {CLI_EVAL_FRAMES} frames in "
          f"{time.perf_counter() - t0:.2f} s")
    argv = cli_argv(root)
    args = parse_cli(TrainArgParser(), argv)
    print(f"train CLI: {PARAMS_FILE} + overrides: bs {args.bs}, epochs {args.epochs}, "
          f"validate_every {args.validate_every}, n_bins {args.n_bins}, "
          f"{args.input_height}x{args.input_width}, {args.compute_dtype}, workers "
          f"{args.workers}, device {args.device}, distributed {args.distributed}")
    batch_ms = loader_batch_ms(args)
    print(f"train CLI: the loader alone, one batch of {TRAIN_BATCH} (native decode and "
          f"augment, {args.num_threads} threads, os.cpu_count() {os.cpu_count()}): first "
          f"{batch_ms[0]:.3f} ms, second {batch_ms[1]:.3f} ms")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with DriverProbe(driver, profile_dir is not None) as probe:
        t0 = time.perf_counter()
        state = driver.main_train(args, max_steps=CLI_STEPS, interactive=False)
        run_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = {"bins_head_fwd": 2 * CLI_EVAL_FRAMES, "bins_head_bwd": 0,
                "bins_head_tc_fwd": CLI_STEPS, "bins_head_tc_bwd": 2 * CLI_STEPS,
                "chamfer": CLI_STEPS}
    print(f"train CLI: main_train(max_steps={CLI_STEPS}) in {run_s:.2f} s, {state.step} "
          f"steps; launches {counts}, expected {expected}")
    check(state.step == CLI_STEPS, "the driver did not take its steps")
    check(counts == expected, f"train CLI launches {counts}, expected {expected}")

    exp_dir = Path(args.exp_dir)
    with open(exp_dir / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    check([(e["tag"], e["step"]) for e in events] == driver_cadence(0, CLI_STEPS),
          "train CLI: the JSONL's tags and steps are not the JAX driver's")
    check(all(np.isfinite(e["value"]) for e in events), "train CLI: a logged value is "
          "not finite")
    losses = [(e["step"], round(e["value"], 6)) for e in events if e["tag"] == "Train/Loss"]
    latest = sorted(exp_dir.glob("*_latest.pt"))
    best = sorted(exp_dir.glob("*_best.pt"))
    check(len(latest) == 1 and len(best) == 1, "train CLI: latest or best missing")
    validate_ms = [ms / n for ms, n in probe.validations]
    save_ms = [ms for ms, _ in probe.saves]
    skip = {v for v in range(CLI_VALIDATE_EVERY, CLI_STEPS, CLI_VALIDATE_EVERY)}
    if profile_dir is not None:  # the profiled steps and the trace's collection
        skip |= set(range(CLI_PROFILE_STEPS[0], CLI_PROFILE_STEPS[1] + 2))
    steps = probe.step_ms(3, CLI_STEPS - 1, skip)
    median = statistics.median(steps.values())
    print(f"train CLI: Train/Loss {losses}; Test/SILog "
          f"{[round(e['value'], 6) for e in events if e['tag'] == 'Test/SILog']}")
    print(f"train CLI: step wall through the driver (from the end of the step before: "
          f"loader wait, step, bookkeeping), update indices 3-{CLI_STEPS - 1} less "
          f"those after a validation"
          + (" and the profiled ones" if profile_dir is not None else "")
          + f": median {median:.3f} ms "
          f"({1e3 * TRAIN_BATCH / median:.2f} images/s; all: "
          + ", ".join(f"{i}: {v:.3f}" for i, v in steps.items())
          + f") against phase 5's synthetic on-device step {synthetic_ms:.3f} ms "
          f"({100 * (median / synthetic_ms - 1):+.1f}%)")
    print(f"train CLI: validation {CLI_EVAL_FRAMES} frames of {FRAME_HW[0]}x{FRAME_HW[1]} "
          f"at batch 1, float32: " + ", ".join(f"{v:.3f}" for v in validate_ms)
          + " ms a frame; checkpoint saves " + ", ".join(f"{v:.1f}" for v in save_ms)
          + f" ms, {probe.saves[0][1]} bytes each; max_memory_allocated {peak} bytes")
    if probe.prof is not None:
        busy_us, n_events = device_busy_us(probe.prof)
        lo, hi = CLI_PROFILE_STEPS
        print(f"train CLI: device-only profile over update indices {lo}-{hi} ({hi - lo + 1} "
              f"steps) through the driver: wall {probe.prof_wall_us / (hi - lo + 1) / 1e3:.3f}"
              f" ms a step (profiled), device busy {100 * busy_us / probe.prof_wall_us:.1f}%, "
              f"{n_events / (hi - lo + 1):.0f} device events a step")
        out = Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke_profile_train_cli.txt").write_text(probe.prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40, max_name_column_width=90))
    alone, busy = loader_contention(args, state)
    print(f"train CLI: the driver's step on one device-resident batch, median of 6: alone "
          f"{alone:.3f} ms, while a thread iterates the loader {busy:.3f} ms "
          f"({100 * (busy / alone - 1):+.1f}%)")
    del state

    # --resume latest: the saved epoch and update, two more steps
    args = parse_cli(TrainArgParser(), argv + ["--resume", "latest"])
    args.exp_dir = str(exp_dir)
    torch.cuda.empty_cache()
    reset_counts()
    state = driver.main_train(args, max_steps=CLI_RESUME_STEPS, interactive=False)
    resumed = read_counts()
    n = CLI_RESUME_STEPS - CLI_STEPS
    expected = {"bins_head_fwd": CLI_EVAL_FRAMES, "bins_head_bwd": 0,
                "bins_head_tc_fwd": n, "bins_head_tc_bwd": 2 * n, "chamfer": n}
    lr = state.optimizer.optimizer.param_groups[0]["lr"]
    want_lr = onecycle_lr_schedule(args.lr, CLI_EPOCHS * CLI_STEPS_PER_EPOCH,
                                   div_factor=args.div_factor,
                                   final_div_factor=args.final_div_factor)(
                                       CLI_RESUME_STEPS - 1)
    with open(exp_dir / "events.jsonl") as f:
        tail = [json.loads(line) for line in f][len(events):]
    print(f"train CLI: --resume latest, main_train(max_steps={CLI_RESUME_STEPS}): step "
          f"{state.step}, epoch {tail[0]['value'] if tail else None}, lr {lr!r} (OneCycle "
          f"at update {CLI_RESUME_STEPS - 1}: {want_lr!r}); launches {resumed}")
    check(state.step == CLI_RESUME_STEPS, "the resumed run did not continue")
    check(resumed == expected, f"resumed launches {resumed}, expected {expected}")
    check(lr == want_lr, "the resumed run's learning rate is not OneCycle's")
    check([(e["tag"], e["step"]) for e in tail] == driver_cadence(CLI_STEPS, CLI_RESUME_STEPS)
          and tail[0]["value"] == CLI_STEPS // CLI_STEPS_PER_EPOCH
          and all(np.isfinite(e["value"]) for e in tail),
          "the resumed run's JSONL is not the JAX driver's from the saved step")
    del state
    torch.cuda.empty_cache()
    return counts, resumed


# --- phase 9: evaluation at B5, DDP, remat, the pretrained backbone --------

EVAL_PARAMS_FILE = "params/args_test_nyu.txt"
DDP_RANKS, DDP_WARMUP, DDP_STEPS = 2, 2, 6
# float32, of the largest gradient value (tests/test_torch_port_ddp.py GRAD_TOL)
DDP_GRAD_TOL = 2e-2
REMAT_LOSS_TOL = 1e-3  # relative: the same forward, bf16 autocast
WIDE_BINS = 512  # above the 256 bins chamfer_kernel keeps in registers


def check_chamfer_wide(chamfer):
    """chamfer_wide_kernel, which runs above 256 bins (no params file does),
    against its plain version on uniform noise at the flagship's pixels,
    with its own generator so that later phases draw what they drew."""
    gen = torch.Generator().manual_seed(SEED + 2)
    _, centers = centers_from(torch.rand((TRAIN_BATCH, WIDE_BINS), generator=gen))
    depth = 0.05 + 9.9 * torch.rand((TRAIN_BATCH, 1, *TRAIN_HW), generator=gen)
    return check_chamfer_reductions(chamfer, centers.cuda(), depth.cuda(),
                                    f"noise, {WIDE_BINS} bins, chamfer_wide_kernel")


def eval_cli(root, gen):
    """Phase 9a: `python -m mde_tpu_torch.evaluate params/args_test_nyu.txt`
    (B5, 256 bins, float32, batch 1 of 480x640) in-process on the phase-8
    eval split, with a seeded B5 checkpoint written by save_checkpoint and
    --save_dir; returns the launches."""
    from mde_tpu_torch import evaluate as ev
    from mde_tpu_torch.checkpoint import save_checkpoint
    from mde_tpu_torch.config import EvalArgParser, parse_cli
    from mde_tpu_torch.data import read_png
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import METRIC_NAMES
    from mde_tpu_torch.train import create_train_state

    data, out = str(root / "nyu"), root / "b5"
    argv = [EVAL_PARAMS_FILE, "--data_path_eval", data, "--gt_path_eval", data,
            "--filenames_file_eval", str(root / "nyu" / "eval.txt"),
            "--checkpoint_path", str(out / "b5_seeded.pt"), "--save_dir", str(out / "pred")]
    args = parse_cli(EvalArgParser(), argv, mode="eval")
    model = build_model(args)
    model.load_state_dict(seeded_state_dict(model, gen), strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    save_checkpoint(create_train_state(model, flagship_args(encoder_name=args.encoder_name), 1),
                    0, "b5_seeded.pt", root=str(out))
    del model

    steps, unrounded = [], []
    real_step, real_run = ev.make_eval_step, ev.run_evaluation

    def make_eval_step(*a, **k):
        step = real_step(*a, **k)

        def timed(*x):
            t0 = time.perf_counter()
            result = step(*x)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            return result
        return timed

    def run_evaluation(*a, **k):
        vals, invalid = real_run(*a, **k)
        unrounded.append(vals)
        return vals, invalid

    ev.make_eval_step, ev.run_evaluation = make_eval_step, run_evaluation
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rounded = ev.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        ev.make_eval_step, ev.run_evaluation = real_step, real_run
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(steps[1:])
    print(f"evaluate B5: {EVAL_PARAMS_FILE} ({args.encoder_name}, {args.n_bins} bins, "
          f"{args.compute_dtype}, {n_params} parameters), {len(steps)} frames of "
          f"{FRAME_HW[0]}x{FRAME_HW[1]} at batch 1: median {median:.3f} ms a frame after the "
          f"first (all: {', '.join(f'{v:.3f}' for v in steps)}), main() {wall:.2f} s, "
          f"max_memory_allocated {peak} bytes; launches {counts}; metrics {rounded}")
    check(counts == {**{k: 0 for k in counts}, "bins_head_fwd": CLI_EVAL_FRAMES},
          f"evaluate B5: launches {counts} for {CLI_EVAL_FRAMES} frames")
    check(all(np.isfinite(v) for v in rounded.values()), "evaluate B5: a metric is not finite")
    lines = (root / "nyu" / "eval.txt").read_text().split()[0::3]
    for image_path in lines:
        path, _ = ev.prediction_path(image_path, args)
        png = read_png(path)
        check(png.shape == FRAME_HW and png.dtype == np.uint16 and png.max() > 0,
              f"evaluate B5: {path}: {png.shape} {png.dtype}")
    check(len(os.listdir(out / "pred")) == CLI_EVAL_FRAMES, "evaluate B5: PNG count")

    # the same frames through the plain head, without the save path
    model = ev.load_eval_model(args, torch.device("cuda"))
    model.fused_head = False
    args.save_dir = None
    reset_counts()
    plain, _ = real_run(args, model)
    check(read_counts() == {k: 0 for k in counts}, "evaluate B5: the plain head launched")
    err = max(abs(unrounded[0][k] - plain[k]) / abs(plain[k]) for k in METRIC_NAMES)
    print(f"evaluate B5: {CLI_EVAL_FRAMES} 16-bit PNGs of {FRAME_HW[0]}x{FRAME_HW[1]} under "
          f"the JAX package's names; metrics against the plain head, largest relative "
          f"difference {err:.3e} (tolerance {METRIC_TOL})")
    check(err <= METRIC_TOL, f"evaluate B5: fused vs plain head metrics {err:.3e}")
    del model
    torch.cuda.empty_cache()
    return counts


def ddp_batch():
    """The phase-9 global batch, from its own seed: image N(0,1), depth
    U(0.05, 9.95) m, on the host."""
    gen = torch.Generator().manual_seed(SEED + 3)
    return {"image": torch.randn((TRAIN_BATCH, 3, *TRAIN_HW), generator=gen),
            "depth": 0.05 + 9.9 * torch.rand((TRAIN_BATCH, 1, *TRAIN_HW), generator=gen)}


def watched_step(state, args, batch):
    """One training step; returns (metrics as floats, the gradients the
    optimizer received, on the host)."""
    from mde_tpu_torch.train import make_train_step
    seen = {}
    real = state.optimizer.step

    def watch(index):
        seen.update({k: torch.zeros_like(p) if p.grad is None else p.grad.detach().cpu()
                     for k, p in state.model.named_parameters()})
        return real(index)

    state.optimizer.step = watch
    state, metrics = make_train_step(args)(state, batch)
    torch.cuda.synchronize()
    return {k: v.item() for k, v in metrics.items()}, seen


def ddp_rank(rank, port, weights_path, out_dir):
    """Phase 9b, one spawned rank on the card: the gloo group, the flagship
    step under DDP on its 8 of the 16 images, bf16 (warm-up and timed steps,
    launches counted) and then one float32 step."""
    from mde_tpu_torch import parallel
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state, make_train_step, wrap_ddp

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.init_distributed(rank, DDP_RANKS, f"tcp://127.0.0.1:{port}", "gloo", "cuda")
    try:
        weights = torch.load(weights_path)
        n = TRAIN_BATCH // DDP_RANKS
        shard = {k: v[rank * n:(rank + 1) * n].cuda() for k, v in ddp_batch().items()}
        out = {}
        for dtype in ("bfloat16", "float32"):
            args = flagship_args(compute_dtype=dtype)
            model = build_model(args)
            model.load_state_dict(weights, strict=True)
            if dtype == "float32":
                no_dropout(model)
            state = wrap_ddp(create_train_state(model.cuda(), args, steps_per_epoch=2693), [0])
            if dtype == "float32":
                out["f32"] = watched_step(state, args, shard)
                continue
            step = make_train_step(args)
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(DDP_WARMUP):
                state, _ = step(state, shard)
            torch.cuda.synchronize()
            ms, per_step, losses = [], [], []
            for _ in range(DDP_STEPS):
                counts = read_counts()
                t0 = time.perf_counter()
                state, m = step(state, shard)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append({k: v - counts[k] for k, v in read_counts().items()})
                losses.append(m["loss"].item())
            out["bf16"] = dict(ms=ms, per_step=per_step, launches=read_counts(), losses=losses,
                               peak=torch.cuda.max_memory_allocated())
            out["bf16"]["search_ms"] = unused_search_ms(state, step, shard, weights, args)
            del state, model, step
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        parallel.destroy_distributed()


def unused_search_ms(state, step, shard, weights, args):
    """Interleaved steps of `state` (wrap_ddp: the encoder's unused BatchNorm
    left out of DDP) and of the same model under DDP's former setting,
    find_unused_parameters=True (the unused parameters found by a walk of
    the autograd graph every step): {"ignore": ms, "search": ms}. Their
    launches are not counted in the phase's."""
    from torch.nn.parallel import DistributedDataParallel
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state
    model = build_model(args)
    model.load_state_dict(weights, strict=True)
    other = create_train_state(model.cuda(), args, steps_per_epoch=2693)
    other.ddp = DistributedDataParallel(other.model, device_ids=[0], broadcast_buffers=False,
                                        find_unused_parameters=True)
    other, _ = step(other, shard)
    times = {"ignore": [], "search": []}
    for _ in range(DDP_STEPS):
        for key, st in (("ignore", state), ("search", other)):
            t0 = time.perf_counter()
            step(st, shard)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
    del other, model
    torch.cuda.empty_cache()
    return times


def no_dropout(model):
    """The mViT's dropout off: each rank draws its own masks, one process
    others, so the float32 comparison of phase 9b runs without it (as
    tests/test_torch_port_ddp.py does)."""
    for m in model.modules():
        if hasattr(m, "dropout"):
            m.dropout = 0.0
    return model


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ddp(state_dict, work, synthetic_ms):
    """Phase 9b: two gloo ranks on the one card (NCCL refuses two ranks on
    one device, so the backend is named, not fallen back to), the flagship
    at a global batch of 16; their float32 step against one process's on
    the whole batch. Returns the launches of both ranks' bf16 steps."""
    import torch.multiprocessing as mp
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state

    work.mkdir(parents=True, exist_ok=True)
    torch.save(state_dict, work / "weights.pt")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(ddp_rank, args=(free_port(), str(work / "weights.pt"), str(work)),
             nprocs=DDP_RANKS, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(DDP_RANKS)]
    launches = dict.fromkeys(STEP_LAUNCHES, 0)
    for r, out in enumerate(ranks):
        bf16 = out["bf16"]
        for i, counts in enumerate(bf16["per_step"]):
            check(counts == STEP_LAUNCHES, f"DDP rank {r} step {i}: launches {counts}, "
                  f"expected {STEP_LAUNCHES}")
        check(all(np.isfinite(bf16["losses"])), f"DDP rank {r}: loss not finite")
        for k, v in bf16["launches"].items():
            launches[k] += v
    check(ranks[0]["bf16"]["losses"] == ranks[1]["bf16"]["losses"],
          "DDP: the ranks' logged losses differ")
    median = statistics.median(ranks[0]["bf16"]["ms"])
    print(f"DDP: {DDP_RANKS} gloo ranks on one card, global batch {TRAIN_BATCH} "
          f"({TRAIN_BATCH // DDP_RANKS} a rank) of {TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16 autocast, "
          f"{DDP_STEPS} steps after {DDP_WARMUP}: rank 0 median {median:.3f} ms (all: "
          + ", ".join(f"{v:.3f}" for v in ranks[0]["bf16"]["ms"])
          + f"), rank 1 median {statistics.median(ranks[1]['bf16']['ms']):.3f} ms, against "
          f"phase 5's one-process step of 16 {synthetic_ms:.3f} ms; losses "
          f"{[round(v, 6) for v in ranks[0]['bf16']['losses']]}; peak a rank "
          f"{[out['bf16']['peak'] for out in ranks]} bytes; launches a rank "
          f"{[out['bf16']['launches'] for out in ranks]}; spawn and run {spawn_s:.1f} s")
    search = ranks[0]["bf16"]["search_ms"]
    print(f"DDP unused-parameter search, rank 0, {DDP_STEPS} interleaved pairs of bf16 steps: "
          f"median {statistics.median(search['ignore']):.3f} ms with the unused BatchNorm "
          f"left out of DDP (all: {', '.join(f'{v:.3f}' for v in search['ignore'])}), "
          f"{statistics.median(search['search']):.3f} ms with find_unused_parameters=True "
          f"(all: {', '.join(f'{v:.3f}' for v in search['search'])})")

    args = flagship_args(compute_dtype="float32")
    model = no_dropout(build_model(args))
    model.load_state_dict(state_dict, strict=True)
    state = create_train_state(model.cuda(), args, steps_per_epoch=2693)
    want, want_grads = watched_step(state, args,
                                    {k: v.cuda() for k, v in ddp_batch().items()})
    got, got_grads = ranks[0]["f32"]
    check(ranks[1]["f32"][0] == got, "DDP float32: the ranks' metrics differ")
    largest = max(g.abs().max().item() for g in want_grads.values())
    err = max(((got_grads[k] - g).abs().max().item() / largest, k)
              for k, g in want_grads.items())
    rank_gap = max((ranks[1]["f32"][1][k] - g).abs().max().item() for k, g in got_grads.items())
    print(f"DDP float32 step, 2 ranks against one process on the 16 images: loss "
          f"{got['loss']:.7f} against {want['loss']:.7f}, silog {got['silog']:.7f} against "
          f"{want['silog']:.7f}, chamfer {got['chamfer']:.7e} against {want['chamfer']:.7e} "
          f"(rtol 2e-4); largest gradient error {err[0]:.3e} of the largest value ({err[1]}; "
          f"tolerance {DDP_GRAD_TOL}); the ranks' gradients differ by {rank_gap:.3e}")
    for k in ("loss", "silog", "chamfer"):
        check(abs(got[k] - want[k]) <= 2e-4 * abs(want[k]), f"DDP float32 {k}")
    check(err[0] <= DDP_GRAD_TOL, f"DDP float32 gradients {err}")
    check(rank_gap == 0.0, "DDP float32: the ranks' gradients differ")
    del state, model
    torch.cuda.empty_cache()
    return launches


def nccl_main_train(root):
    """Phase 9b': main_train under --distributed in a torchrun-style
    environment of one rank: NCCL's process group and the DDP wrapper on the
    card, 2 steps and a validation of the phase-8 eval split. Returns the
    launches."""
    from torch.nn.parallel import DistributedDataParallel
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.train import driver

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    seen = {}
    real = driver.make_train_step

    def make_train_step(*a, **k):
        seen["backend"] = torch.distributed.get_backend()
        return real(*a, **k)

    driver.make_train_step = make_train_step
    try:
        args = parse_cli(TrainArgParser(), cli_argv(root) + [
            "--distributed", "--root", str(root / "runs_nccl")])
        reset_counts()
        t0 = time.perf_counter()
        state = driver.main_train(args, max_steps=2, interactive=False)
        run_s = time.perf_counter() - t0
        counts = read_counts()
    finally:
        driver.make_train_step = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    expected = {"bins_head_fwd": CLI_EVAL_FRAMES, "bins_head_bwd": 0, "bins_head_tc_fwd": 2,
                "bins_head_tc_bwd": 4, "chamfer": 2}
    print(f"DDP through main_train: --distributed, WORLD_SIZE 1, backend {seen.get('backend')}, "
          f"wrapper {type(state.ddp).__name__}: {state.step} steps and a validation of "
          f"{CLI_EVAL_FRAMES} frames in {run_s:.2f} s; launches {counts}, expected {expected}")
    check(seen.get("backend") == "nccl" and isinstance(state.ddp, DistributedDataParallel),
          "main_train --distributed did not run NCCL and DDP")
    check(not torch.distributed.is_initialized(), "main_train left its process group")
    check(state.step == 2 and counts == expected, f"DDP main_train launches {counts}")
    del state
    torch.cuda.empty_cache()
    return counts


def remat(state_dict, gen, profile_dir, synthetic_ms, synthetic_peak):
    """Phase 9c: the phase-5 step with --remat encoder: one step from the
    same weights and batch as without it (the same loss to bf16 rounding,
    BN buffers moved once), then 2 + 8 timed steps; returns their launches."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state, make_train_step

    batch = train_batch(flagship_args(), torch.Generator().manual_seed(SEED + 4), TRAIN_BATCH,
                        TRAIN_HW)
    first = {}
    for policy in ("none", "encoder"):
        args = flagship_args(remat=policy)
        model = build_model(args)
        model.load_state_dict(state_dict, strict=True)
        state = create_train_state(model.cuda(), args, steps_per_epoch=2693)
        _, m = make_train_step(args)(state, batch)
        torch.cuda.synchronize()
        first[policy] = (m["loss"].item(), {k: v.clone() for k, v in model.named_buffers()})
        del state, model
        torch.cuda.empty_cache()
    (loss, bufs), (r_loss, r_bufs) = first["none"], first["encoder"]
    stat_err = max(((r_bufs[k] - v).abs().max() / v.abs().max().clamp(min=1e-30)).item()
                   for k, v in bufs.items() if "running_" in k)
    print(f"train remat: first step from the phase-5 weights, loss {r_loss:.7f} against "
          f"{loss:.7f} without remat (tolerance {REMAT_LOSS_TOL} relative); BN running stats "
          f"largest difference {stat_err:.3e} of the largest value; num_batches_tracked "
          f"{sorted({int(v) for k, v in r_bufs.items() if 'num_batches' in k})}")
    check(abs(r_loss - loss) <= REMAT_LOSS_TOL * abs(loss), "remat changed the loss")
    check(all(int(v) == 1 for k, v in r_bufs.items() if "num_batches" in k),
          "remat moved the BN buffers more than once")
    check(stat_err <= 1e-3, f"remat BN running stats {stat_err:.3e}")

    args = flagship_args(remat="encoder")
    model = build_model(args)
    model.load_state_dict(state_dict, strict=True)
    counts, ms, peak = train(args, model.cuda(), gen, profile_dir, "train remat")
    print(f"train remat against phase 5: median {ms:.3f} against {synthetic_ms:.3f} ms "
          f"({100 * (ms / synthetic_ms - 1):+.1f}%), max_memory_allocated {peak} against "
          f"{synthetic_peak} bytes ({100 * (peak / synthetic_peak - 1):+.1f}%)")
    check(peak < synthetic_peak, "remat did not lower the peak")
    del model
    torch.cuda.empty_cache()
    return counts


def pretrained_backbone(gen, work):
    """Phase 9d: a seeded B1 backbone .npz (flax-tree layout) into cue
    configuration A's 73-channel stem on the card."""
    from mde_tpu_torch.checkpoint import backbone_trees, save_backbone_npz
    from mde_tpu_torch.models.efficientnet import EfficientNetEncoder
    from mde_tpu_torch.train.driver import apply_pretrained_backbone

    encoder = EfficientNetEncoder("efficientnet-b1")
    encoder.load_state_dict(seeded_state_dict(encoder, gen), strict=True)
    want = encoder.state_dict()
    path = work / "backbone_b1.npz"
    save_backbone_npz(*backbone_trees(want, "efficientnet-b1"), str(path))
    args = flagship_args(**CUE_CONFIGS["A"], pretrained_backbone=str(path))
    model = seeded_model(args, gen)
    stem = model.encoder.original_model.conv_stem.weight.detach().cpu().clone()
    apply_pretrained_backbone(model, args)
    got = {k: v.cpu() for k, v in model.encoder.original_model.state_dict().items()}
    check(torch.equal(got["conv_stem.weight"][:, :3], want["conv_stem.weight"]),
          "pretrained backbone: the stem's RGB slice is not the file's")
    check(torch.equal(got["conv_stem.weight"][:, 3:], stem[:, 3:]),
          "pretrained backbone: the stem's cue slice moved")
    rest = [k for k in want if k != "conv_stem.weight" and "num_batches" not in k]
    check(all(torch.equal(got[k], want[k]) for k in rest),
          "pretrained backbone: a weight or BN stat is not the file's")
    print(f"pretrained backbone: {path.name} ({path.stat().st_size} bytes) into configuration "
          f"A's stem {tuple(stem.shape)}: RGB slice equal to the file's, {stem.shape[1] - 3} cue "
          f"channels untouched, {len(rest)} other tensors (weights and BN stats) the file's")
    del model


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile requests under four cuDNN settings and the "
                             "training steps, and write the tables to DIR; print the cue "
                             "ops' share of the A step")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    from mde_tpu_torch.data import native
    from mde_tpu_torch.kernels import bins_head, build, chamfer
    from mde_tpu_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)

    toolchain(build)
    build_all(build, {bins_head._SOURCE: bins_head.library,
                      bins_head._TC_SOURCE: bins_head.tc_library,
                      chamfer._SOURCE: chamfer.library, native.SOURCE: native.library})

    serving_fwd = check_head_forward(bins_head, gen, 2, (FRAME_HW[0] // 2, FRAME_HW[1] // 2),
                                     "serving")[torch.float32]
    fwd = check_head_forward(bins_head, gen, TRAIN_BATCH, (TRAIN_HW[0] // 2, TRAIN_HW[1] // 2),
                             "training")
    bwd = check_head_backward(bins_head, gen)
    check_chunked_head(bins_head, gen)
    torch.cuda.empty_cache()
    cham = check_chamfer(chamfer, gen)
    wide = check_chamfer_wide(chamfer)
    cublas_yardstick(gen)
    torch.cuda.empty_cache()

    # each path is driven with the counts at 0 and read right after it; its
    # launches add to the kernels line
    launches = dict.fromkeys(STEP_LAUNCHES, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    add(serve(bins_head, gen, args.profile))
    torch.cuda.empty_cache()

    flagship = flagship_args()
    model = build_model(flagship)
    state_dict = seeded_state_dict(model, gen)
    model.load_state_dict(state_dict, strict=True)
    counts, train_ms, train_peak = train(flagship, model.cuda(), gen, args.profile, "train")
    add(counts)
    del model
    torch.cuda.empty_cache()
    # the float32 head backward is on no main path: its launches come from
    # the float32 step checks
    launches["bins_head_bwd"] += step_against_plain(state_dict, gen,
                                                    torch.float32)["bins_head_bwd"]
    torch.cuda.empty_cache()
    step_against_plain(state_dict, gen, torch.bfloat16)
    torch.cuda.empty_cache()

    check_embedders(gen)
    eval_ms = {}
    for name in ("no cues", "A", "B"):
        counts, eval_ms[name] = evaluate(name, gen, args.profile)
        add(counts)
        torch.cuda.empty_cache()
    print("eval, median ms a frame: " + ", ".join(f"{k} {v:.3f}" for k, v in eval_ms.items()))
    cue_a = flagship_args(**CUE_CONFIGS["A"])
    counts, cue_ms, cue_peak = train(cue_a, seeded_model(cue_a, gen), gen, args.profile,
                                     "train A")
    add(counts)
    print(f"train A against the no-cue step of this run: median {cue_ms:.3f} against "
          f"{train_ms:.3f} ms ({100 * (cue_ms / train_ms - 1):+.1f}%), "
          f"{1e3 * TRAIN_BATCH / cue_ms:.2f} against {1e3 * TRAIN_BATCH / train_ms:.2f} "
          f"images/s, peak {cue_peak} against {train_peak} bytes")
    torch.cuda.empty_cache()
    cue_b = seeded_state_dict(build_model(flagship_args(**CUE_CONFIGS["B"])), gen)
    launches["bins_head_bwd"] += step_against_plain(cue_b, gen, torch.float32,
                                                    "B")["bins_head_bwd"]
    torch.cuda.empty_cache()
    step_against_plain(cue_b, gen, torch.bfloat16, "B")
    torch.cuda.empty_cache()
    add(no_adabins(gen))
    build_dir = REPO / ".build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        root = Path(tmp)
        for counts in train_cli(root, args.profile, train_ms):
            add(counts)
        add(eval_cli(root, gen))
        add(ddp(state_dict, root / "ddp", train_ms))
        add(nccl_main_train(root))
        add(remat(state_dict, gen, args.profile, train_ms, train_peak))
        pretrained_backbone(gen, root)
    print(f"chamfer_wide_kernel ({WIDE_BINS} bins, on no main path: every params file has 256 "
          f"bins): " + json.dumps(wide))
    print(f"launches over the main paths (the float32 head backward from the step "
          f"checks): {launches}")
    check(all(launches.values()), f"a kernel was launched no time: {launches}")

    head = "mde_tpu/kernels/bins_head.py"
    rows = [("bins_head_fwd", "mde_tpu_torch/csrc/bins_head.cu", f"{head}:76", serving_fwd),
            ("bins_head_bwd", "mde_tpu_torch/csrc/bins_head.cu", f"{head}:84",
             bwd[torch.float32]),
            ("bins_head_tc_fwd", "mde_tpu_torch/csrc/bins_head_tc.cu", f"{head}:76",
             fwd[torch.bfloat16]),
            ("bins_head_tc_bwd", "mde_tpu_torch/csrc/bins_head_tc.cu", f"{head}:84",
             bwd[torch.bfloat16]),
            ("chamfer", "mde_tpu_torch/csrc/chamfer.cu", "mde_tpu/kernels/chamfer.py:48", cham)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
         "library_ms": None}
        for name, source, replaces, s in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
