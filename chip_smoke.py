#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`mde_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile DIR   # also write profiler tables to DIR,
                                          # and the cue ops' share of the A step
    python3 chip_smoke.py --only tp       # phases 1-2, 5 and 9e alone (a quick
                                          # check of tensor parallelism; no
                                          # result line)
    python3 chip_smoke.py --only tp-nccl  # phase 9e's NCCL ranks alone, on a
                                          # machine with two cards or more

Phases, each of which ends the run with a non-zero exit if it fails:
  1. toolchain: torch, CUDA, nvcc, device capability, triton, card and power,
     and whether matplotlib and scipy are there (the port needs scipy, for
     the colour table and the Sobel edges, and no matplotlib: it colours
     its pictures from its own tables)
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
     the bound, and the loss and gradient on the noise; chamfer_wide_kernel
     (above 256 bins) at 512, 1,024 and 2,048 bins on the same two maps,
     min, nearest depth, count and y_min equal to the plain version's, the
     depth sum at rtol 1e-5, each timed with its share of the bound; and,
     as yardsticks of the card's rates, two cuBLAS products of
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
     kernels) and under bf16 autocast (the tensor-core ones); then the
     flagship bf16 step at 512 bins: its first loss against the plain
     chamfer's on the same weights and batch (rtol 2e-2), 2 warm-up and 4
     timed steps, each launching the tensor-core head forward once, its
     backward kernels once each and chamfer_wide_kernel once
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
     two validations of the 16 frames at batch 1 in the training's bf16,
     latest and best checkpoints, the qualitative figures (Train/QualSamples
     at step 0, Test/QualSamples at each validation); exactly 12 x (1, 2,
     1) bf16 head forward / backward and chamfer launches, one bf16 head
     forward an eval frame and one a figure, no float32 one, finite losses,
     the JSONL's tags and steps at the JAX driver's cadence, figures
     included, each figure's PNG decoded at its panels' size (2 x 3 cells of
     416x544, the prediction 208x272); then --resume latest with
     max_steps=14: epoch 1, update 12, two steps, the learning rate of
     OneCycle's update 13, the validation and its figure. Prints the
     driver's median step beside phase 5's synthetic step, the loader's
     time for one batch of 16 alone, the validation ms a frame, each
     figure's forward and host ms, the checkpoint save ms and bytes, the
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
     (e) tensor parallelism (--mesh_shape): two gloo ranks spawned on the one
         card at 1,2, the flagship (B1, 256 bins, 416x544, all 16 images on
         each rank, bf16, AdamW + OneCycle + clip 0.1, the fused head and
         chamfer kernels): 2 warm-up and 6 timed steps, 1/2/1 launches a
         rank a step, equal losses, the replicated parameters' SHA-256
         equal on the ranks after the steps; with --profile the model-group
         collectives' share of one step's device and host time on rank 0;
         one float32 step, dropout on, against one process's (loss rtol
         2e-4, the gradients the update applied within 2e-2 of the largest
         value); main_train --distributed --mesh_shape 1,2 on the phase-8
         tree, 2 steps, a validation and its figure with their exact
         launches, its latest checkpoint loaded into one process, each
         rank's slices the file's; then 2,2 on four gloo ranks, one float32
         step without dropout, 8 images a data rank, against one process on
         the 16; with two cards or more, 1,m over NCCL on m = min(4, cards)
         cards (bf16 steps and the float32 check)
 10. offline cue generation, with seeded weights at full width (no checkpoint
     is in the repo), on a tree of 8 copies of the NYU frame with depth PNGs:
     (a) `python -m mde_tpu_torch.offline.generate_semantics` in process:
         HRNetV2-W48 + C1, bf16, five scales (300-600 on the short side,
         padded to /32), one uint8 semantic_seg_*.npy a frame; ms a frame,
         peak bytes, device events a frame; bf16 against float32 at 480x640
         (argmax agreement, at least HRNET_BF16_AGREE; largest score
         difference); the float32 card against the CPU at 128x192
     (b) `generate_instances` (ade20k, --depths, --stats-out, a low
         --score-thr): Swin-B Cascade Mask R-CNN, bf16, 800x1067 padded to
         800x1088, the instance npz pair a frame (every frame with
         detections) and the area/depth pickle; ms a frame, peak, device
         events, the split of a frame (Swin-B + FPN, RPN with its NMS, the
         cascade, the classes' NMS, the masks; the host's paste and collapse);
         the RPN's and the classes' NMS and the roi feature extractions of a
         frame on its own inputs: ms, device events, peak, card equal to
         CPU; bf16 and float32 valid counts; FPN maps, RPN outputs and the
         cascade's probabilities of fixed rois, float32 card against CPU
     (c) main_train with the sem_glove-25d_inst_ade20k_swin insertion-point-
         input params file on the generated side files: 2 steps and the
         closing validation, finite losses, non-empty cue channels, exact
         launches. No TPU kernel lies on the offline path: its generators
         launch none of the port's kernels.
 11. offline training and evaluation, seeded weights at full width, on a
     COCO tree of 8 copies of the NYU frame (polygons of two parts with float
     vertices, uncompressed RLE, bbox-only, crowd and sub-pixel boxes over
     100 classes), none of it launching a port kernel:
     (a) `python -m mde_tpu_torch.offline.train_detector` in process: Swin-B
         Cascade Mask R-CNN, 100 classes, bf16 from float32 masters,
         use_checkpoint, the full AutoAugment scale set (up to 800x1067,
         padded to 800x1088), --max-gt 100, 2 warm-up and 8 timed steps:
         every loss finite; step median / min / max ms, peak bytes, device
         events a step; the mmdet-layout checkpoint loads strictly through
         load_detector, every tensor equal
     (b) one float32 step at a fixed 256x352 scale (128 rois a stage) on the
         card and on the CPU with the same sampler draws: losses rtol 1e-3,
         the bbox heads' updated BN stats 1e-4 relative
     (c) one bf16 step at 800x1088 with and without use_checkpoint, the same
         draws: losses within 1e-3, a lower peak with it
     (d) `eval_detector` on the tree with (a)'s checkpoint: bbox and segm mAP
         and mAP50, each in [0, 1] or NaN; ms a frame
     (e) HRNetV2-W48 + C1 training: 150 classes, float32, batch 2 of 480x640,
         labels at 120x160 with a -1 border, SGD + poly, 2 + 8 steps on one
         batch (finite, the last loss below the first; ms, peak, device
         events); one step at 128x192 card against CPU (loss rtol 1e-4, BN
         buffers 1e-4 relative)
     (f) `eval_semseg` on an odgt of 4 frames with seeded CSAIL-named
         encoder / decoder files and --result-dir: each prediction equal to a
         direct hrnet_multiscale_inference call, mIoU and accuracy, the RGB
         grids written
 12. CSAIL's semantic-segmentation zoo and the infer demo, seeded weights:
     (a) each published ADE20K combination the JAX zoo builds
         (resnet18/50/101dilated-ppm_deepsup, mobilenetv2dilated-
         c1_deepsup, resnet18dilated-c1_deepsup, resnet50/101-upernet) and
         resnext101-upernet, at its published widths with 150 classes:
         float32 card against CPU at 128x160 (log-probabilities, 1e-4 of
         the largest), then bf16 on the NYU frame at 480x640 (softmax at the
         frame's size): ms a frame, device events, peak
     (b) make_semseg_train_step of resnet50dilated-ppm_deepsup, float32,
         batch 2 of 480x640, 5 steps: finite, falling loss; step ms, peak,
         busy share
     (c) predict_pil(visualized=True) and `python -m mde_tpu_torch.infer`
         with a seeded checkpoint in the demo's layout: the coloured
         picture and ./thingy.png of the frame's size, with no matplotlib
         imported
 13. one JSON line on the kernels (launches summed over the main paths:
     serving, training, the eval and cue training runs, the train CLI, the
     B5 evaluation, both DDP ranks, the DDP driver run, the remat steps,
     the tensor-parallel ranks' steps and driver run, phase 10's cue
     training and phase 12's request; chamfer_wide_kernel's from phase 6's
     512-bin steps, its row's times from phase 3 at 512 bins on the noise;
     the float32 head backward, which no main path runs, from the float32
     step checks), then the result line.

float32 comparisons run with TF32 off for both cuDNN and cuBLAS. The script
imports no JAX: it is the quickest proof that the port runs on the card.
"""

import argparse
import gc
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
                 "bins_head_tc_bwd": 2, "chamfer": 1, "chamfer_wide": 0}
F32_STEP_LAUNCHES = {"bins_head_fwd": 1, "bins_head_bwd": 2, "bins_head_tc_fwd": 0,
                     "bins_head_tc_bwd": 0, "chamfer": 1, "chamfer_wide": 0}
# above 256 bins the chamfer is chamfer_wide_kernel (the 512-bin step)
WIDE_STEP_LAUNCHES = dict(STEP_LAUNCHES, chamfer=0, chamfer_wide=1)
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


def check_chamfer_reductions(chamfer, centers, depth, label, exact=False):
    """The reductions kernel against its plain version on one depth map;
    returns its stats. The function's work: per (bin, valid pixel) pair one
    squared distance (a subtract and a multiply), then about 4 compares and
    selects for the per-pixel min with its tie count and the per-bin min
    with its depth. Outputs at rtol 1e-5, atol 1e-6, or where `exact` equal
    but for the depth sum (the same squared distances picked by the same
    rule; counts of whole pixels)."""
    flat = depth.reshape(depth.shape[0], -1)
    want = chamfer.chamfer_reductions_reference(centers, flat)
    got = chamfer.chamfer_reductions(centers, flat)
    torch.cuda.synchronize()
    abs_err = 0.0
    for name, g, r in zip(("min", "nearest", "count", "depth_sum", "y_min"), got, want):
        abs_err = max(abs_err, (g - r).abs().max().item())
        tol = (0.0, 0.0) if exact and name != "depth_sum" else (1e-5, 1e-6)
        torch.testing.assert_close(g, r, rtol=tol[0], atol=tol[1], msg=f"{label} {name}")
    ms = cuda_ms(lambda: chamfer.chamfer_reductions(centers, flat), iters=10)
    plain_ms = cuda_ms(lambda: chamfer.chamfer_reductions_reference(centers, flat),
                       iters=3, warmup=1)
    valid = int((flat >= 1e-3).sum())
    ops = 6 * centers.shape[1] * valid
    nbytes = 2 * flat.numel() * 4 + centers.numel() * 4
    least = bound(ops, F32_OPS, nbytes)
    print(f"chamfer reductions, {label} ({flat.shape[0]} x {TRAIN_HW[0]}x{TRAIN_HW[1]} pixels, "
          f"{valid} valid, {centers.shape[1]} bins): max_abs_err {abs_err:.3e} "
          f"({'exact but the depth sum at rtol 1e-5' if exact else 'rtol 1e-5, atol 1e-6'}); "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
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


def profiled(fn):
    """(out, device events, device busy ms, wall ms, the profile) of one call
    of fn under the profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_us, n = device_busy_us(prof)
    return out, n, busy_us / 1e3, wall, prof


def top_device_ops(prof, n=4):
    """The n ops of a profile with the most device time of their own: name, ms."""
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:n]
    return ", ".join(f"{name[:60]} {us / 1e3:.1f} ms" for name, us in rows)


def op_table(prof, rows=30, sort_by="self_device_time_total", by_shape=False, **kw):
    """A profile's table by op (and input shape), the most device time first."""
    return prof.key_averages(group_by_input_shape=by_shape).table(
        sort_by=sort_by, row_limit=rows, **{"max_name_column_width": 90, **kw})


def write_profile(profile_dir, name, *tables):
    """The tables, one after another, to chip_smoke_profile_<name>.txt under
    --profile's directory; nothing without --profile."""
    if profile_dir is None:
        return
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"chip_smoke_profile_{name}.txt").write_text("\n".join(tables))


def profile(helper, frames, out_dir):
    """For cuDNN TF32 off and on, and for cudnn.benchmark: the median request
    latency, device time by kernel and by op input shape over 2 requests, and
    the device's busy share (the union of kernel intervals over the wall)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
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
        by_kernel = op_table(prof, 25)
        by_shape = op_table(prof, 25, "device_time_total", by_shape=True,
                            max_name_column_width=40, max_shapes_column_width=100)
        write_profile(out_dir, tag, by_kernel, by_shape)
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
    bins_head.TC_LAUNCHES = bins_head.TC_BWD_LAUNCHES = chamfer.WIDE_LAUNCHES = 0


def read_counts():
    from mde_tpu_torch.kernels import bins_head, chamfer
    return {"bins_head_fwd": bins_head.LAUNCHES, "bins_head_bwd": bins_head.BWD_LAUNCHES,
            "bins_head_tc_fwd": bins_head.TC_LAUNCHES,
            "bins_head_tc_bwd": bins_head.TC_BWD_LAUNCHES, "chamfer": chamfer.LAUNCHES,
            "chamfer_wide": chamfer.WIDE_LAUNCHES}


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
    def two_steps(state):
        for _ in range(2):
            state, _ = step(state, batch)

    _, n_events, busy_ms, wall_ms, prof = profiled(lambda: two_steps(state))
    busy_us, wall_us = busy_ms * 1e3, wall_ms * 1e3
    events = device_events(prof)
    total = sum(e.time_range.elapsed_us() for e in events)
    ours = {name: sum(e.time_range.elapsed_us() for e in events if name in e.name)
            for name in ("bins_head_fwd_kernel", "bins_head_bwd_pixel_kernel",
                         "bins_head_bwd_weight_kernel", "bins_head_tc_fwd_kernel",
                         "bins_head_tc_bwd_pixel_kernel", "bins_head_tc_bwd_weight_kernel",
                         "chamfer_kernel")}
    write_profile(profile_dir, label, op_table(prof, 40))
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
    _, n_events, busy_ms, wall_ms, prof = profiled(lambda: run_validate(args, model, frames[:4]))
    busy_us, wall_us = busy_ms * 1e3, wall_ms * 1e3
    total = sum(e.time_range.elapsed_us() for e in device_events(prof))
    write_profile(out_dir, f"eval_{name.replace(' ', '_')}", op_table(prof))
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


def nyu_tree(root, n_train=CLI_TRAIN_FRAMES, n_eval=CLI_EVAL_FRAMES):
    """The NYU-format tree: n_train + n_eval copies of CLASSROOM, each with a
    smooth millimetre depth map of its own (two sinusoids, 500-9,000 mm) as a
    16-bit PNG, and the two split files."""
    scene = root / "classroom_0001"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:FRAME_HW[0], 0:FRAME_HW[1]]
    lines = []
    for i in range(n_train + n_eval):
        fy, fx, py, px = rng.uniform(0.5, 2.0, 2).tolist() + rng.uniform(0, 1, 2).tolist()
        wave = (0.5 + 0.25 * np.sin(2 * np.pi * (fy * yy / FRAME_HW[0] + py))
                + 0.25 * np.cos(2 * np.pi * (fx * xx / FRAME_HW[1] + px)))
        shutil.copyfile(CLASSROOM, scene / f"rgb_{i:05d}.jpg")
        write_png16(scene / f"sync_depth_{i:05d}.png", np.rint(500 + 8500 * wave).astype(np.uint16))
        lines.append(f"/classroom_0001/rgb_{i:05d}.jpg /classroom_0001/sync_depth_{i:05d}.png "
                     "518.8579")
    (root / "train.txt").write_text("\n".join(lines[:n_train]) + "\n")
    (root / "eval.txt").write_text("\n".join(lines[n_train:]) + "\n")


def driver_cadence(first_step, max_steps):
    """(tag, step) of every scalar and figure mde_tpu/train/driver.py's epoch
    loop and `bookkeep` write from `first_step` to `max_steps`."""
    from mde_tpu_torch.ops import METRIC_NAMES
    out, step = [("Epoch", first_step)], first_step
    while True:
        if step % 5 == 0:
            out += [("Train/Loss", step), ("Train/SILog", step), ("Train/ChamferLoss", step)]
        if step % 500 == 0:
            out.append(("Train/QualSamples", step))
        step += 1
        if step % CLI_VALIDATE_EVERY == 0 or step >= max_steps:
            out += ([("Test/SILog", step)] + [(f"Metrics/{k}", step) for k in METRIC_NAMES]
                    + [("Test/QualSamples", step)])
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
        self.stamps, self.validations, self.saves, self.figures = [], [], [], []
        self.prof = self.prof_wall_us = None
        self.real = {k: getattr(driver, k) for k in ("make_train_step", "validate",
                                                     "save_checkpoint", "make_figure_forward",
                                                     "log_qual_figure")}

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

        def make_figure_forward(*a, **k):
            forward = self.real["make_figure_forward"](*a, **k)

            def timed(*x):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred = forward(*x)
                torch.cuda.synchronize()
                self.figures.append([(time.perf_counter() - t0) * 1e3])
                return pred
            return timed

        def log_qual_figure(*a, **k):
            t0 = time.perf_counter()
            self.real["log_qual_figure"](*a, **k)
            self.figures[-1].append((time.perf_counter() - t0) * 1e3)

        for name, fn in (("make_train_step", make_train_step), ("validate", validate),
                         ("save_checkpoint", save_checkpoint),
                         ("make_figure_forward", make_figure_forward),
                         ("log_qual_figure", log_qual_figure)):
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


def check_figures(events, exp_dir):
    """Each figure line of the JSONL names its PNG in the experiment
    directory, which the port's decoder reads at the size of its panels:
    2 rows x 3 columns (RGB, GT, prediction) in cells of the crop's size
    (the prediction, at the model's half resolution, sits in its cell's top
    left on white), GUTTER pixels between cells."""
    from mde_tpu_torch.data import read_png
    from mde_tpu_torch.utils.graphs import GUTTER
    figures = [e for e in events if "figure" in e]
    h, w = TRAIN_HW
    for e in figures:
        path = Path(e["figure"])
        check(path == exp_dir / f"{e['tag'].replace('/', '_')}_{e['step']}.png",
              f"train CLI: figure {path}")
        png = read_png(path)
        check(png.shape == (2 * h + GUTTER, 3 * w + 2 * GUTTER, 3) and png.dtype == np.uint8,
              f"train CLI: {path.name}: {png.shape} {png.dtype}")
        pred = png[:h, 2 * (w + GUTTER):]
        check((pred[h // 2:] == 255).all() and (pred[:, w // 2:] == 255).all()
              and (pred[:h // 2, :w // 2] != 255).any(axis=-1).mean() > 0.5,
              f"train CLI: {path.name}: the prediction's panel is not 208x272")
    return figures


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
    # bf16: each step, each eval frame of the two validations (the training's
    # compute dtype) and each of the three figures (Train/QualSamples at 0,
    # Test/QualSamples at both validations)
    expected = {"bins_head_fwd": 0, "bins_head_bwd": 0,
                "bins_head_tc_fwd": CLI_STEPS + 2 * CLI_EVAL_FRAMES + 3,
                "bins_head_tc_bwd": 2 * CLI_STEPS, "chamfer": CLI_STEPS,
                "chamfer_wide": 0}
    print(f"train CLI: main_train(max_steps={CLI_STEPS}) in {run_s:.2f} s, {state.step} "
          f"steps; launches {counts}, expected {expected}")
    check(state.step == CLI_STEPS, "the driver did not take its steps")
    check(counts == expected, f"train CLI launches {counts}, expected {expected}")

    exp_dir = Path(args.exp_dir)
    with open(exp_dir / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    check([(e["tag"], e["step"]) for e in events] == driver_cadence(0, CLI_STEPS),
          "train CLI: the JSONL's tags and steps are not the JAX driver's")
    check(all(np.isfinite(e["value"]) for e in events if "value" in e),
          "train CLI: a logged value is not finite")
    figures = check_figures(events, exp_dir)
    check(len(figures) == len(probe.figures) == 3 and all(len(f) == 2 for f in probe.figures),
          "train CLI: three figures expected")
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
    print("train CLI: figures " + ", ".join(f"{e['tag']}@{e['step']}" for e in figures)
          + ": forward (synchronized) "
          + ", ".join(f"{f[0]:.3f}" for f in probe.figures) + " ms; host (copy, panels, PNG) "
          + ", ".join(f"{f[1]:.3f}" for f in probe.figures) + " ms")
    print(f"train CLI: validation {CLI_EVAL_FRAMES} frames of {FRAME_HW[0]}x{FRAME_HW[1]} "
          f"at batch 1, {args.compute_dtype}: " + ", ".join(f"{v:.3f}" for v in validate_ms)
          + " ms a frame; checkpoint saves " + ", ".join(f"{v:.1f}" for v in save_ms)
          + f" ms, {probe.saves[0][1]} bytes each; max_memory_allocated {peak} bytes")
    if probe.prof is not None:
        busy_us, n_events = device_busy_us(probe.prof)
        lo, hi = CLI_PROFILE_STEPS
        print(f"train CLI: device-only profile over update indices {lo}-{hi} ({hi - lo + 1} "
              f"steps) through the driver: wall {probe.prof_wall_us / (hi - lo + 1) / 1e3:.3f}"
              f" ms a step (profiled), device busy {100 * busy_us / probe.prof_wall_us:.1f}%, "
              f"{n_events / (hi - lo + 1):.0f} device events a step")
        write_profile(profile_dir, "train_cli", op_table(probe.prof, 40))
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
    expected = {"bins_head_fwd": 0, "bins_head_bwd": 0,
                "bins_head_tc_fwd": n + CLI_EVAL_FRAMES + 1, "bins_head_tc_bwd": 2 * n,
                "chamfer": n, "chamfer_wide": 0}
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
          and all(np.isfinite(e["value"]) for e in tail if "value" in e),
          "the resumed run's JSONL is not the JAX driver's from the saved step")
    check(len(check_figures(tail, exp_dir)) == 1, "the resumed run drew no Test figure")
    del state
    torch.cuda.empty_cache()
    return counts, resumed


# --- phase 9: evaluation at B5, DDP, remat, the pretrained backbone --------

EVAL_PARAMS_FILE = "params/args_test_nyu.txt"
DDP_RANKS, DDP_WARMUP, DDP_STEPS = 2, 2, 6
# float32, of the largest gradient value (tests/test_torch_port_ddp.py GRAD_TOL)
DDP_GRAD_TOL = 2e-2
REMAT_LOSS_TOL = 1e-3  # relative: the same forward, bf16 autocast
WIDE_BINS = (512, 1024, 2048)  # above the 256 bins chamfer_kernel keeps in registers
WIDE_STEP_BINS, WIDE_WARMUP, WIDE_STEPS = 512, 2, 4


def check_chamfer_wide(chamfer):
    """chamfer_wide_kernel, which runs above 256 bins (no params file does),
    against its plain version at the flagship's pixels, at each of
    WIDE_BINS on uniform noise and on the smooth millimetre map: min,
    nearest depth, count and y_min equal, the depth sum at rtol 1e-5. Its
    own generator, so that later phases draw what they drew; returns the
    stats of each (bins, map)."""
    gen = torch.Generator().manual_seed(SEED + 2)
    depth = (0.05 + 9.9 * torch.rand((TRAIN_BATCH, 1, *TRAIN_HW), generator=gen)).cuda()
    smooth = smooth_depth(TRAIN_BATCH, *TRAIN_HW, torch.Generator().manual_seed(SEED + 1))
    smooth = smooth.cuda()
    stats = {}
    for p in WIDE_BINS:
        _, centers = centers_from(torch.rand((TRAIN_BATCH, p), generator=gen))
        centers = centers.cuda()
        for name, d in (("noise", depth), ("smooth mm map", smooth)):
            stats[p, name] = check_chamfer_reductions(
                chamfer, centers, d, f"{name}, chamfer_wide_kernel", exact=True)
        torch.cuda.empty_cache()
    return stats


def train_wide():
    """The flagship bf16 step at WIDE_STEP_BINS bins, where the chamfer is
    chamfer_wide_kernel: the first step's loss against the same model's
    with the plain chamfer (rtol STEP_TOL), then WIDE_WARMUP + WIDE_STEPS
    steps, each launching the tensor-core head and the wide chamfer
    (WIDE_STEP_LAUNCHES). Its own generator; returns the timed steps'
    launches."""
    from mde_tpu_torch.train import create_train_state, make_loss_fn, make_train_step

    gen = torch.Generator().manual_seed(SEED + 3)
    args = flagship_args(n_bins=WIDE_STEP_BINS)
    model = seeded_model(args, gen).train()
    batch = train_batch(args, gen, TRAIN_BATCH, TRAIN_HW)
    losses = {}
    with torch.no_grad():
        for kernel in (True, False):
            loss_fn = make_loss_fn(flagship_args(n_bins=WIDE_STEP_BINS,
                                                 use_pallas_chamfer=kernel))
            loss, _, l_chamfer = loss_fn(model, batch,
                                         torch.Generator(device="cuda").manual_seed(SEED))
            losses[kernel] = (loss.item(), l_chamfer.item())
    tol = STEP_TOL[torch.bfloat16]
    print(f"wide step ({WIDE_STEP_BINS} bins): first loss {losses[True][0]:.7f} (chamfer "
          f"{losses[True][1]:.7e}) against the plain chamfer's {losses[False][0]:.7f} "
          f"({losses[False][1]:.7e}); relative difference "
          f"{abs(losses[True][0] - losses[False][0]) / abs(losses[False][0]):.3e} (rtol {tol})")
    for kernel_v, plain_v in zip(losses[True], losses[False]):
        check(abs(kernel_v - plain_v) <= tol * abs(plain_v),
              f"wide step: loss {losses[True]} against the plain chamfer's {losses[False]}")

    state = create_train_state(model, args, steps_per_epoch=2693)
    step = make_train_step(args)
    for _ in range(WIDE_WARMUP):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for i in range(WIDE_STEPS):
        counts = read_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v - counts[k] for k, v in read_counts().items()}
        check(all(np.isfinite(v.item()) for v in m.values()), f"wide step {i}: not finite")
        check(per_step == WIDE_STEP_LAUNCHES,
              f"wide step {i}: launches {per_step}, expected {WIDE_STEP_LAUNCHES}")
    launches = read_counts()
    print(f"wide step ({WIDE_STEP_BINS} bins): {WIDE_STEPS} steps after {WIDE_WARMUP} warm-up, "
          f"batch {TRAIN_BATCH} of {TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16 autocast: median step "
          f"{statistics.median(step_ms):.3f} ms (all: "
          f"{', '.join(f'{v:.3f}' for v in step_ms)}), last loss {m['loss'].item():.6f}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, launches "
          f"{launches}")
    del state, model
    return launches


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
    # bf16: 2 steps, the validation's frames and 2 figures (steps 0 and 2)
    expected = {"bins_head_fwd": 0, "bins_head_bwd": 0,
                "bins_head_tc_fwd": 2 + CLI_EVAL_FRAMES + 2, "bins_head_tc_bwd": 4, "chamfer": 2,
                "chamfer_wide": 0}
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


# --- phase 9e: tensor parallelism ---------------------------------------------

TP_MESH = "1,2"  # the model group of the one card's gloo ranks
TP_MESH_22 = "2,2"
TP_WARMUP, TP_STEPS = 2, 6
TP_LOSS_RTOL = 2e-4  # float32, against one process (JAX's 1-vs-N parity)
TP_GRAD_TOL = 2e-2  # float32, of the largest gradient value (tests/test_torch_port_tp.py)
TP_COLLECTIVE = "model group collective"  # the profiler's name for their ranges
TP_SPAWN_LIMIT_S = 300  # a spawn of ranks that takes longer has hung
# the share of the card's free memory that the gloo ranks on it take in all
# (their CUDA contexts and gloo's staging take the rest)
TP_CARD_SHARE = 0.9


def tp_state(args, weights, dropout, device):
    """The flagship model with `weights`, cut to this rank's slices
    (models/tp.py) on the card, its train state under DDP."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.models.tp import shard_model
    from mde_tpu_torch.train import create_train_state, wrap_ddp
    model = build_model(args)
    model.load_state_dict(weights, strict=True)
    if not dropout:
        no_dropout(model)
    model = shard_model(model).to(device)
    return wrap_ddp(create_train_state(model, args, steps_per_epoch=2693), [device.index])


def clipped_step(state, args, batch):
    """One training step; returns (metrics as floats, the gradients the
    update applied (the tensor-parallel slices averaged over their data
    group and gathered; all of them clipped), on the host, the clip's global
    norm). Under tensor parallelism every rank of the model group calls it."""
    from mde_tpu_torch import parallel
    from mde_tpu_torch.train import make_train_step
    seen = {}
    real = state.optimizer.step

    def watch(index):
        seen["norm"] = real(index).item()
        seen["grads"] = {parallel.plain_name(k): p.grad.detach().clone()
                         for k, p in state.model.named_parameters()}
        return seen["norm"]

    state.optimizer.step = watch
    state, metrics = make_train_step(args)(state, batch)
    layout = getattr(state.model, "tp_layout", None) or {}
    grads = parallel.gather_state_dict(seen["grads"], layout)
    torch.cuda.synchronize()
    return ({k: v.item() for k, v in metrics.items()}, {k: v.cpu() for k, v in grads.items()},
            seen["norm"])


def replicated_digest(model):
    """SHA-256 of the parameters the model group does not split."""
    from mde_tpu_torch import parallel
    digest = hashlib.sha256()
    for k, p in model.named_parameters():
        if parallel.plain_name(k) not in model.tp_layout:
            digest.update(p.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def collective_share(state, step, batch):
    """One bf16 step under the profiler with the model group's collectives in
    ranges of their own: (device ms inside them, the step's device busy ms,
    host ms inside them, the step's wall ms, their count). Every rank of
    the group runs it."""
    from mde_tpu_torch.parallel import tensor

    def ranged(fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(TP_COLLECTIVE):
                return fn(*a, **k)
        return wrapped

    real = tensor._all_reduce, tensor.place_and_gather
    tensor._all_reduce, tensor.place_and_gather = map(ranged, real)
    try:
        _, _, busy_ms, wall_ms, prof = profiled(lambda: step(state, batch))
    finally:
        tensor._all_reduce, tensor.place_and_gather = real
    ranges = [e for e in prof.events() if e.name == TP_COLLECTIVE]
    return (sum(e.device_time_total for e in ranges) / 1e3, busy_ms,
            sum(e.cpu_time_total for e in ranges) / 1e3, wall_ms, len(ranges))


def tp_bf16_steps(weights, batch, device, profile):
    """The flagship bf16 step on this rank: warm-up and timed steps with
    their launches, the losses, the peak, the replicated parameters' digest
    after them, and with `profile` the collectives' share of one more step."""
    from mde_tpu_torch.train import make_train_step
    args = flagship_args()
    state = tp_state(args, weights, True, device)
    step = make_train_step(args)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TP_WARMUP):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    ms, per_step, losses = [], [], []
    for _ in range(TP_STEPS):
        counts = read_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - counts[k] for k, v in read_counts().items()})
        losses.append(m["loss"].item())
    out = dict(ms=ms, per_step=per_step, launches=read_counts(), losses=losses,
               peak=torch.cuda.max_memory_allocated(), digest=replicated_digest(state.model),
               split=len(state.model.tp_layout))
    if profile:
        out["share"] = collective_share(state, step, batch)
    del state, step
    torch.cuda.empty_cache()
    return out


def tp_f32_step(weights, batch, device, dropout):
    """One float32 step on this rank: (metrics, gathered gradients, norm)
    and its launches."""
    args = flagship_args(compute_dtype="float32")
    state = tp_state(args, weights, dropout, device)
    reset_counts()
    result = clipped_step(state, args, batch)
    counts = read_counts()
    del state
    torch.cuda.empty_cache()
    return result, counts


def tp_driver(root, mesh_shape):
    """main_train --distributed --mesh_shape on the phase-8 tree, 2 steps and
    the closing validation: the launches, this rank's slices of the split
    parameters and the experiment directory."""
    from mde_tpu_torch import parallel
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.train import driver
    args = parse_cli(TrainArgParser(), cli_argv(root) + [
        "--distributed", "--mesh_shape", mesh_shape, "--root", str(root / "runs_tp")])
    reset_counts()
    t0 = time.perf_counter()
    state = driver.main_train(args, max_steps=2, interactive=False)
    run_s = time.perf_counter() - t0
    local = parallel.local_state_dict(state.model)
    return dict(launches=read_counts(), step=state.step, exp_dir=args.exp_dir, run_s=run_s,
                split={k: local[k].cpu() for k in state.model.tp_layout},
                layout=dict(state.model.tp_layout))


def tp_rank(index, stages, backend, weights_path, out_dir, profile, free_bytes):
    """Phase 9e, one spawned process: for each stage (world size, mesh shape,
    jobs, port) whose world holds it, join that world as rank `index` (gloo
    on the one card, where NCCL refuses two ranks on one device, or NCCL on
    card `index`), run the jobs and write what the main process checks
    (rank 0 the gathered gradients), then leave it. One spawn serves every
    stage, so the ranks reach the card once. Ranks that share the one card
    each take at most their share of the `free_bytes` the spawn found, so
    that cuDNN picks algorithms whose workspace fits beside the others'."""
    from mde_tpu_torch import parallel
    device = torch.device("cuda", index if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = torch.load(weights_path)
    for world_size, mesh_shape, jobs, port in stages:
        if index >= world_size:
            continue
        gc.collect()  # the last stage's DDP and group, before this one's peaks
        torch.cuda.empty_cache()
        if backend == "gloo":
            total = torch.cuda.get_device_properties(device).total_memory
            torch.cuda.set_per_process_memory_fraction(
                TP_CARD_SHARE * free_bytes / world_size / total, device)
        parallel.init_distributed(index, world_size, f"tcp://127.0.0.1:{port}", backend, "cuda",
                                  mesh_shape)
        try:
            g = parallel.grid()
            n = TRAIN_BATCH // g.data
            batch = {k: v[g.data_index * n:(g.data_index + 1) * n].to(device)
                     for k, v in ddp_batch().items()}
            out = {}
            for job in jobs:
                if job == "bf16":  # every rank runs the profiled step: it has collectives
                    out[job] = tp_bf16_steps(weights, batch, device, profile)
                elif job in ("f32", "f32 no dropout"):
                    (metrics, grads, norm), counts = tp_f32_step(weights, batch, device,
                                                                 job == "f32")
                    out[job] = dict(metrics=metrics, norm=norm, launches=counts,
                                    grads=grads if index == 0 else None)
                elif job == "driver":
                    out[job] = tp_driver(Path(out_dir).parent, mesh_shape)
            torch.save(out, os.path.join(out_dir, f"{backend}_{mesh_shape}_{index}.pt"))
        finally:
            parallel.destroy_distributed()


def spawn_tp(work, backend, stages, profile=False):
    """Run the stages ((world size, mesh shape, jobs), largest world first)
    on one spawn of processes; each stage's results, by mesh shape, and the
    spawn's seconds. Processes still running after TP_SPAWN_LIMIT_S (a hung
    collective) are ended and the phase fails."""
    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"TP {backend}: {free} of {total} bytes free on card 0 before the spawn; this "
          f"process holds {torch.cuda.memory_allocated()} allocated, "
          f"{torch.cuda.memory_reserved()} reserved")
    t0 = time.perf_counter()
    stages = [(w, mesh, jobs, free_port()) for w, mesh, jobs in stages]
    context = mp.start_processes(tp_rank, args=(stages, backend, str(work / "weights.pt"),
                                                str(work), profile, free),
                                 nprocs=max(w for w, *_ in stages), join=False,
                                 start_method="spawn")
    try:
        while not context.join(timeout=5):
            check(time.perf_counter() - t0 < TP_SPAWN_LIMIT_S,
                  f"TP {backend}: the ranks ran over {TP_SPAWN_LIMIT_S} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.terminate()
    spawn_s = time.perf_counter() - t0
    return ({mesh: [torch.load(work / f"{backend}_{mesh}_{r}.pt") for r in range(w)]
             for w, mesh, _, _ in stages}, spawn_s)


def check_tp_steps(label, ranks, want):
    """Every rank's float32 metrics, and rank 0's gathered gradients,
    against one process's (`want`). The model ranks of a data index compute
    the replicated layers each on its own, so their float32 losses may
    differ by the card's choice of kernels; their update is DDP's one
    mean."""
    got = ranks[0]
    gap = max(abs(r["metrics"][k] - got["metrics"][k]) / abs(got["metrics"][k])
              for r in ranks for k in ("loss", "silog", "chamfer"))
    w_metrics, w_grads, w_norm = want
    largest = max(g.abs().max().item() for g in w_grads.values())
    err = max(((got["grads"][k] - g).abs().max().item() / largest, k)
              for k, g in w_grads.items())
    print(f"{label}: loss {got['metrics']['loss']:.7f} against {w_metrics['loss']:.7f}, silog "
          f"{got['metrics']['silog']:.7f} against {w_metrics['silog']:.7f}, chamfer "
          f"{got['metrics']['chamfer']:.7e} against {w_metrics['chamfer']:.7e} (rtol "
          f"{TP_LOSS_RTOL}); the clip's norm {got['norm']:.6f} against {w_norm:.6f}; largest "
          f"gradient error {err[0]:.3e} of the largest value ({err[1]}; tolerance "
          f"{TP_GRAD_TOL}); the ranks' metrics {gap:.3e} apart (relative), their norms "
          f"{[r['norm'] for r in ranks]}; launches a rank {[r['launches'] for r in ranks]}")
    for r in ranks:
        for k in ("loss", "silog", "chamfer"):
            check(abs(r["metrics"][k] - w_metrics[k]) <= TP_LOSS_RTOL * abs(w_metrics[k]),
                  f"{label}: {k} {r['metrics'][k]} against {w_metrics[k]}")
    check(err[0] <= TP_GRAD_TOL, f"{label}: gradients {err}")
    check(all(r["launches"] == F32_STEP_LAUNCHES for r in ranks),
          f"{label}: launches {[r['launches'] for r in ranks]}")


def check_tp_bf16(label, ranks, synthetic_ms):
    """Each rank's bf16 steps: 1/2/1 launches a step, finite and equal
    losses, the replicated parameters equal; prints the step medians."""
    for r, out in enumerate(ranks):
        for i, counts in enumerate(out["per_step"]):
            check(counts == STEP_LAUNCHES, f"{label} rank {r} step {i}: launches {counts}, "
                  f"expected {STEP_LAUNCHES}")
        check(all(np.isfinite(out["losses"])), f"{label} rank {r}: loss not finite")
    check(all(out["losses"] == ranks[0]["losses"] for out in ranks),
          f"{label}: the ranks' logged losses differ")
    check(len({out["digest"] for out in ranks}) == 1,
          f"{label}: the replicated parameters differ between the ranks")
    print(f"{label}: {len(ranks)} ranks, {ranks[0]['split']} parameters split a rank, batch "
          f"{TRAIN_BATCH} of {TRAIN_HW[0]}x{TRAIN_HW[1]} on every rank, bf16 autocast, "
          f"{TP_STEPS} steps after {TP_WARMUP}: median a rank "
          + ", ".join(f"{statistics.median(out['ms']):.3f}" for out in ranks)
          + f" ms (rank 0 all: {', '.join(f'{v:.3f}' for v in ranks[0]['ms'])})"
          + ("" if synthetic_ms is None else
             f" against phase 5's one-process step {synthetic_ms:.3f} ms") + "; losses "
          f"{[round(v, 6) for v in ranks[0]['losses']]}; peak a rank "
          f"{[out['peak'] for out in ranks]} bytes; replicated parameters equal on the ranks "
          f"(SHA-256 {ranks[0]['digest'][:16]}); launches a rank "
          f"{[out['launches'] for out in ranks]}")
    if "share" in ranks[0]:
        dev_ms, busy_ms, host_ms, wall_ms, n = ranks[0]["share"]
        print(f"{label}: profiled step on rank 0: {n} model-group collectives, {dev_ms:.3f} ms "
              f"of device time inside them of {busy_ms:.3f} ms busy "
              f"({100 * dev_ms / busy_ms:.1f}%), {host_ms:.3f} ms of host time inside them of "
              f"a {wall_ms:.3f} ms step ({100 * host_ms / wall_ms:.1f}%)")


def check_tp_driver(ranks, state_dict):
    """main_train's run on both ranks; its latest checkpoint loaded into one
    process: every split slice of each rank is the file's slice, every other
    tensor the one-process shape, all finite. Returns its launches."""
    from mde_tpu_torch.checkpoint import load_checkpoint
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state
    outs = [r["driver"] for r in ranks]
    # bf16: 2 steps, the validation's frames and 2 figures (steps 0 and 2)
    expected = {"bins_head_fwd": 0, "bins_head_bwd": 0,
                "bins_head_tc_fwd": 2 + CLI_EVAL_FRAMES + 2, "bins_head_tc_bwd": 4, "chamfer": 2,
                "chamfer_wide": 0}
    for r, out in enumerate(outs):
        check(out["step"] == 2 and out["launches"] == expected,
              f"TP main_train rank {r}: step {out['step']}, launches {out['launches']}")
    exp_dir = Path(outs[0]["exp_dir"])
    (latest,) = exp_dir.glob("*_latest.pt")
    args = flagship_args()
    model = build_model(args)
    state = create_train_state(model, args, steps_per_epoch=CLI_STEPS_PER_EPOCH)
    state, _ = load_checkpoint(str(latest), state)
    full = model.state_dict()
    check(state.step == 2 and full.keys() == state_dict.keys()
          and all(full[k].shape == v.shape for k, v in state_dict.items()),
          "TP checkpoint: not the one-process layout")
    check(all(torch.isfinite(v).all() for v in full.values() if v.is_floating_point()),
          "TP checkpoint: not finite")
    for r, out in enumerate(outs):
        for k, local in out["split"].items():
            dim, index = out["layout"][k]
            check(torch.equal(full[k].index_select(dim, index), local),
                  f"TP checkpoint: rank {r}'s {k} is not the file's slice")
    print(f"TP main_train: --distributed --mesh_shape {TP_MESH} on {len(outs)} gloo ranks: 2 "
          f"steps and a validation of {CLI_EVAL_FRAMES} frames in "
          + ", ".join(f"{out['run_s']:.2f}" for out in outs)
          + f" s; launches a rank {outs[0]['launches']} (expected {expected}); "
          f"{latest.name} ({latest.stat().st_size} bytes) loaded into one process, each rank's "
          f"{len(outs[0]['split'])} slices the file's")
    launches = dict.fromkeys(STEP_LAUNCHES, 0)
    for out in outs:
        for k, v in out["launches"].items():
            launches[k] += v
    return launches


def gloo_ranks(work, state_dict, synthetic_ms, profile, want, add):
    """Phase 9e on the one card: one spawn of four gloo processes, 2,2 (a
    float32 step without dropout) then 1,2 on two of them (bf16 steps, a
    float32 step with dropout, the driver); their checks, their launches
    through `add`."""
    results, spawn_s = spawn_tp(work, "gloo", [(4, TP_MESH_22, ["f32 no dropout"]),
                                               (2, TP_MESH, ["bf16", "f32", "driver"])],
                                profile)
    ranks = results[TP_MESH]
    check_tp_bf16(f"TP {TP_MESH} gloo", [r["bf16"] for r in ranks], synthetic_ms)
    check_tp_steps(f"TP {TP_MESH} gloo float32 step, dropout on, against one process",
                   [r["f32"] for r in ranks], want[True])
    for r in ranks:
        add(r["bf16"]["launches"])
        add(r["f32"]["launches"])
    add(check_tp_driver(ranks, state_dict))

    ranks = results[TP_MESH_22]
    check_tp_steps(f"TP {TP_MESH_22} gloo float32 step, {TRAIN_BATCH // 2} images a data rank, "
                   f"dropout off, against one process on {TRAIN_BATCH}",
                   [r["f32 no dropout"] for r in ranks], want[False])
    for r in ranks:
        add(r["f32 no dropout"]["launches"])
    print(f"TP gloo: one spawn of 4 processes, {TP_MESH_22} on 4 then {TP_MESH} on 2 of them, "
          f"{spawn_s:.1f} s")


def tensor_parallel(state_dict, root, synthetic_ms, profile, gloo=True):
    """Phase 9e: the flagship under --mesh_shape 1,2 on two gloo ranks of
    the one card (bf16 steps, a float32 step with dropout against one
    process's, the driver), 2,2 on four (a float32 step without dropout),
    and with two cards or more 1,m over NCCL (alone without `gloo`).
    Returns the launches of the ranks' steps and driver runs."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state
    t0 = time.perf_counter()
    work = root / "tp"
    work.mkdir(parents=True, exist_ok=True)
    torch.save(state_dict, work / "weights.pt")
    device = torch.device("cuda", 0)
    want = {}
    for dropout in (True, False) if gloo else (True,):
        args = flagship_args(compute_dtype="float32")
        model = build_model(args)
        model.load_state_dict(state_dict, strict=True)
        if not dropout:
            no_dropout(model)
        state = create_train_state(model.to(device), args, steps_per_epoch=2693)
        want[dropout] = clipped_step(state, args, {k: v.to(device) for k, v in ddp_batch().items()})
        del state, model
        torch.cuda.empty_cache()

    launches = dict.fromkeys(STEP_LAUNCHES, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    if gloo:
        gloo_ranks(work, state_dict, synthetic_ms, profile, want, add)
    cards = torch.cuda.device_count()
    check(gloo or cards >= 2, "TP over NCCL needs two cards or more")
    if cards >= 2:
        m = min(4, cards)
        results, spawn_s = spawn_tp(work, "nccl", [(m, f"1,{m}", ["bf16", "f32"])])
        ranks = results[f"1,{m}"]
        check_tp_bf16(f"TP 1,{m} NCCL over {m} cards", [r["bf16"] for r in ranks], synthetic_ms)
        check_tp_steps(f"TP 1,{m} NCCL float32 step, dropout on, against one process",
                       [r["f32"] for r in ranks], want[True])
        for r in ranks:
            add(r["bf16"]["launches"])
            add(r["f32"]["launches"])
        print(f"TP 1,{m} NCCL: spawn and run {spawn_s:.1f} s")
    print(f"tensor parallelism: phase 9e in {time.perf_counter() - t0:.1f} s; gloo ranks on one "
          f"card measure correctness and host-staged collectives, not the scaling of tensor "
          f"parallelism")
    return launches


# --- phase 10: offline cue generation ----------------------------------------

OFFLINE_TRAIN_FRAMES, OFFLINE_EVAL_FRAMES = 6, 2  # 8 frames, each gets its side files
OFFLINE_PARAMS_FILE = ("params/args_train_nyu_efficientnet-b1_sem_glove-25d_inst_ade20k_swin_"
                       "insertion_point_input.txt")
OFFLINE_SEED = 0
# a seeded head's class probabilities sit near 1/101; 0.011 keeps the top few
OFFLINE_SCORE_THR = 0.011
OFFLINE_SMALL_HW = (128, 192)  # card against CPU, float32, TF32 off
OFFLINE_REL_TOL = 1e-4   # card vs CPU, float32: of the largest magnitude of the output
OFFLINE_PROB_TOL = 1e-3  # card vs CPU, float32: the cascade's probabilities, absolute
# card vs CPU, float32: HRNet's softmax at seg_size, absolute. The seeded
# trunk's logits reach ~3,800 (flax's initialisation, identity BatchNorm
# stats), so an error of 3e-6 of that (0.012) moves a near-tie's
# probability by up to half as much: 9.1e-4 on an H100
HRNET_PROB_TOL = 1e-2
HRNET_BF16_AGREE = 0.9   # least share of pixels whose bf16 class is float32's
DETECTOR_STAGES = ("features", "proposals", "cascade", "multiclass_nms", "masks")


class Clock:
    """Wraps named callables of objects so that each call is synchronized and
    timed (`times[label]`, ms a call; `ends[label]`, host time at each end)."""

    def __init__(self):
        self.times, self.ends, self._undo = {}, {}, []

    def wrap(self, owner, name, label=None):
        real = getattr(owner, name)
        label = label or name
        self.times[label], self.ends[label] = [], []

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.times[label].append((t1 - t0) * 1e3)
            self.ends[label].append(t1)
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, real))

    def restore(self):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)
        self._undo = []


def device_event_count(fn):
    """Device events (kernels, copies, fills) of one call of fn, by the profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return len(device_events(prof)), out


def frame_walls(ends):
    """ms between consecutive frame ends, the first frame left out."""
    return [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]


def rel_err(got, want):
    return float((got.cpu().double() - want.double()).abs().max()
                 / want.double().abs().max().clamp(min=1e-30))


def run_cli(module, factory, argv):
    """module.main(argv) with its model factory wrapped to keep the model;
    the frame function (`segment` / `detect`) and, for the instances, the host
    `cue_maps` timed. Returns (model, clock, seconds, peak bytes)."""
    seen = {}
    real = getattr(module, factory)

    def build(args, device):
        seen["model"] = real(args, device)
        return seen["model"]

    clock = Clock()
    setattr(module, factory, build)
    clock.wrap(module, "segment" if hasattr(module, "segment") else "detect", "frame")
    if hasattr(module, "cue_maps"):
        clock.wrap(module, "cue_maps")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        module.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        setattr(module, factory, real)
        clock.restore()
    return seen["model"], clock, seconds, torch.cuda.max_memory_allocated()


def offline_semantics(tree, card):
    """Phase 10a: generate_semantics over the tree; then bf16 against float32
    at full size, and the float32 card against the CPU at a small frame."""
    from mde_tpu_torch.data import read_rgb
    from mde_tpu_torch.offline import generate_semantics as gs
    from mde_tpu_torch.offline import hrnet as hrnet_module
    from mde_tpu_torch.offline.hrnet import (IMG_SIZES, HRNetV2C1, _scale_plan,
                                             hrnet_multiscale_inference)

    model, clock, seconds, peak = run_cli(gs, "build_model", [
        "--images", str(tree), "--random-init", str(OFFLINE_SEED)])
    frames = sorted(tree.rglob("rgb_*.jpg"))
    for f in frames:
        seg = np.load(str(f).replace("rgb", "semantic_seg").replace(".jpg", ".npy"))
        check(seg.dtype == np.uint8 and seg.shape == FRAME_HW and int(seg.max()) < 150,
              f"semantics of {f.name}: {seg.dtype} {seg.shape}")
    img = read_rgb(frames[0]).astype(np.float32) / 255.0
    events, _ = device_event_count(lambda: gs.segment(model, img))
    params = sum(p.numel() for p in model.parameters())
    walls = frame_walls(clock.ends["frame"])
    split = Clock()
    split.wrap(hrnet_module, "resize_bilinear_pil", "host resizes")
    split.wrap(model, "forward", "forwards")
    split.wrap(gs, "segment")
    try:
        for _ in range(2):
            gs.segment(model, img)
    finally:
        split.restore()
        del model.forward
    n = len(IMG_SIZES)
    parts = {k: sum(v[-n:]) if k != "segment" else v[-1] for k, v in split.times.items()}
    print(f"offline semantics [{card}]: generate_semantics --random-init {OFFLINE_SEED} over "
          f"{len(frames)} frames of {FRAME_HW[0]}x{FRAME_HW[1]} in {seconds:.2f} s; HRNetV2-W48 + "
          f"C1, {params} parameters, bf16, five scales (padded "
          + ", ".join(f"{ph}x{pw}" for _, (ph, pw) in _scale_plan(*FRAME_HW))
          + f"): segment {statistics.median(clock.times['frame'][1:]):.3f} ms a frame after the "
          f"first (first {clock.times['frame'][0]:.3f}), frame to frame (decode, segment, save) "
          f"{statistics.median(walls):.3f} ms; peak {peak} bytes; {events} device events a frame")
    print(f"offline semantics [{card}]: split of frame 0 (synchronized around each part): "
          f"segment {parts['segment']:.3f} ms = the {n} PIL-exact resizes on the host "
          f"{parts['host resizes']:.3f} ms + the {n} forwards to softmax at 480x640 "
          f"{parts['forwards']:.3f} ms + the rest (normalise, pad, H2D, sum, argmax, D2H) "
          f"{parts['segment'] - parts['host resizes'] - parts['forwards']:.3f} ms")

    f32 = seeded_once(HRNetV2C1, OFFLINE_SEED, "hrnet").cuda().eval()

    def summed(m):
        acc = []

        def apply_fn(x, seg_size):
            out = m(x.cuda(), seg_size)
            acc.append(out[0])
            return out

        with torch.inference_mode():
            classes = hrnet_multiscale_inference(apply_fn, img)
        return classes, torch.stack(acc).sum(0)

    cls16, s16 = summed(model)
    cls32, s32 = summed(f32)
    agree = float((cls16 == cls32).mean())
    diff = float((s16.float() - s32).abs().max())
    print(f"offline semantics [{card}]: bf16 against float32 at {FRAME_HW[0]}x{FRAME_HW[1]}, "
          f"the same seeded weights: argmax agrees on {100 * agree:.3f}% of pixels (at least "
          f"{100 * HRNET_BF16_AGREE:.0f}%), largest difference of the summed scores {diff:.4e} "
          f"(of 5)")
    check(agree >= HRNET_BF16_AGREE, f"bf16 HRNet agrees with float32 on {agree:.4f}")

    cpu = seeded_once(HRNetV2C1, OFFLINE_SEED, "hrnet").eval()
    x = torch.randn((1, 3, *OFFLINE_SMALL_HW), generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        soft = (f32(x.cuda(), OFFLINE_SMALL_HW).cpu(), cpu(x, OFFLINE_SMALL_HW))
        logs = (f32(x.cuda()).cpu(), cpu(x))
    soft_err = float((soft[0] - soft[1]).abs().max())
    log_err = rel_err(*logs)
    print(f"offline semantics [{card}]: float32 card against CPU at {OFFLINE_SMALL_HW[0]}x"
          f"{OFFLINE_SMALL_HW[1]} (TF32 off): softmax at seg_size {soft_err:.3e} (tol "
          f"{HRNET_PROB_TOL:g}), log-softmax {log_err:.3e} of its largest magnitude "
          f"{float(logs[1].abs().max()):.1f} (tol {OFFLINE_REL_TOL:g})")
    check(soft_err <= HRNET_PROB_TOL and log_err <= OFFLINE_REL_TOL,
          "HRNet on the card differs from the CPU")
    del model, f32, cpu
    torch.cuda.empty_cache()


def offline_ops(model, img, card):
    """Phase 10b: the RPN's and the classes' NMS and the roi feature
    extractions of one frame, on its own inputs: launches, times, the card
    against the CPU (equal)."""
    from mde_tpu_torch.offline import cascade_rcnn, detection_ops
    from mde_tpu_torch.offline import generate_instances as gi

    nms_calls, feats, proposals, dets = [], {}, {}, {}
    real_nms = cascade_rcnn.batched_nms_fixed

    def nms(*a):
        nms_calls.append(a)
        return real_nms(*a)

    real = {name: getattr(model, name) for name in ("features", "proposals", "multiclass_nms")}
    model.features = lambda *a: feats.setdefault("v", real["features"](*a))
    model.proposals = lambda *a: proposals.setdefault("v", real["proposals"](*a))
    model.multiclass_nms = lambda *a: dets.setdefault("v", real["multiclass_nms"](*a))
    cascade_rcnn.batched_nms_fixed = nms
    try:
        gi.detect(model, img)
    finally:
        cascade_rcnn.batched_nms_fixed = real_nms
        for name in real:
            delattr(model, name)
    for label, (boxes, scores, ids, thr, max_out) in zip(("rpn", "classes"), nms_calls):
        events, got = device_event_count(lambda: real_nms(boxes, scores, ids, thr, max_out))
        want = real_nms(boxes.cpu(), scores.cpu(), ids.cpu(), thr, max_out)
        equal = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        ms = cuda_ms(lambda: real_nms(boxes, scores, ids, thr, max_out), iters=5, warmup=1)
        print(f"offline NMS [{card}]: {label}: {boxes.shape[0]} candidates, {max_out} steps, IoU "
              f"{thr}: {ms:.3f} ms, {events} device events a call, {int(got[1].sum())} kept; "
              f"card equals CPU: {equal}")
        check(equal, f"{label} NMS on the card differs from the CPU")
    fpn = feats["v"][:4]
    for label, rois, size in (("cascade rois", proposals["v"][0], 7),
                              ("mask rois", dets["v"][0], 14)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = detection_ops.extract_roi_features(fpn, rois, size)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want = detection_ops.extract_roi_features([f.cpu() for f in fpn], rois.cpu(), size)
        ms = cuda_ms(lambda: detection_ops.extract_roi_features(fpn, rois, size), iters=5)
        equal = torch.equal(got.cpu(), want)
        events, _ = device_event_count(lambda: detection_ops.extract_roi_features(fpn, rois, size))
        print(f"offline RoIAlign [{card}]: {label}: {rois.shape[0]} rois on their FPN levels "
              f"({fpn[0].dtype} maps), {size}x{size} bins, 2x2 taps: {ms:.3f} ms, {events} device "
              f"events, {peak} bytes above the inputs at peak; card equals CPU: {equal}")
        check(equal, "RoIAlign on the card differs from the CPU")


def offline_instances(tree, card):
    """Phase 10b: generate_instances over the tree (ade20k, --depths,
    --stats-out); the split of a frame; NMS and RoIAlign; bf16 against
    float32 at full size; the float32 card against the CPU at a small frame."""
    import pickle

    from mde_tpu_torch.data import read_rgb
    from mde_tpu_torch.offline import generate_instances as gi
    from mde_tpu_torch.offline.cascade_rcnn import CascadeMaskRCNN

    stats = tree / "instance_stats.pkl"
    model, clock, seconds, peak = run_cli(gi, "build_detector", [
        "--images", str(tree), "--random-init", str(OFFLINE_SEED), "--score-thr",
        str(OFFLINE_SCORE_THR), "--depths", str(tree), "--stats-out", str(stats)])
    frames = sorted(tree.rglob("rgb_*.jpg"))
    with_detections = 0
    for f in frames:
        maps = [np.load(str(f).replace("rgb", f"instance_{k}_ade20k_swin").replace(".jpg", ".npz"),
                        allow_pickle=True)["arr_0"] for k in ("labels", "areas")]
        if maps[0].dtype != object:
            check(maps[0].shape == maps[1].shape == FRAME_HW and maps[0].dtype == np.int32
                  and int(maps[0].max()) < 100, f"instance maps of {f.name}")
            with_detections += int((maps[0] >= 0).any())
    with open(stats, "rb") as fh:
        points = pickle.load(fh)
    check(with_detections == len(frames), f"{with_detections} of {len(frames)} frames have "
          "detections: lower --score-thr")
    check(len(points) == 101 and sum(map(len, points)) > 0, "no area/depth statistics")
    img = read_rgb(frames[0])
    events, det = device_event_count(lambda: gi.detect(model, img))
    n_valid16 = int(det["valid"].sum())
    split = Clock()
    split.wrap(gi, "preprocess")
    for name in DETECTOR_STAGES:
        split.wrap(model, name)
    split.wrap(gi, "detect")
    try:
        for _ in range(2):
            gi.detect(model, img)
    finally:
        split.restore()
        for name in DETECTOR_STAGES:
            delattr(model, name)
    params = sum(p.numel() for p in model.parameters())
    walls = frame_walls(clock.ends["cue_maps"])
    stage_ms = {k: v[-1] for k, v in split.times.items()}
    print(f"offline instances [{card}]: generate_instances --random-init {OFFLINE_SEED} "
          f"--score-thr {OFFLINE_SCORE_THR} --depths --stats-out over {len(frames)} frames in "
          f"{seconds:.2f} s; Swin-B Cascade Mask R-CNN, {params} parameters, bf16, 800x1067 "
          f"padded to 800x1088: detect {statistics.median(clock.times['frame'][1:]):.3f} ms a "
          f"frame after the first (first {clock.times['frame'][0]:.3f}), paste + collapse on the "
          f"host {statistics.median(clock.times['cue_maps'][1:]):.3f} ms, frame to frame "
          f"(decode, resize, detect, paste, collapse, save) {statistics.median(walls):.3f} ms; "
          f"peak {peak} bytes; {events} device events a frame; {n_valid16} valid detections on "
          f"frame 0, {sum(map(len, points))} area/depth points")
    print(f"offline instances [{card}]: split of frame 0 (synchronized between stages): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items())
          + f", the rest of detect (H2D, D2H, box scaling) "
          f"{stage_ms['detect'] - sum(v for k, v in stage_ms.items() if k != 'detect'):.3f} ms "
          "(preprocess = the host's PIL-exact upscale, normalisation and padding; features = "
          "Swin-B + FPN; proposals = RPN head, top-k, NMS; cascade = 3 bbox stages; "
          "multiclass_nms = the classes' NMS; masks = 3 mask heads)")
    offline_ops(model, img, card)

    f32 = seeded_once(lambda: CascadeMaskRCNN(100, OFFLINE_SCORE_THR), OFFLINE_SEED,
                      "detector 100").cuda().eval()
    n_valid32 = int(gi.detect(f32, img)["valid"].sum())
    print(f"offline instances [{card}]: bf16 against float32 at 800x1088, the same seeded "
          f"weights: {n_valid16} against {n_valid32} valid detections on frame 0 (both must "
          f"have some)")
    check(n_valid16 > 0 and n_valid32 > 0, "a detector found nothing")

    cpu = seeded_once(lambda: CascadeMaskRCNN(100, OFFLINE_SCORE_THR), OFFLINE_SEED,
                      "detector 100").eval()
    x = torch.randn((1, 3, *OFFLINE_SMALL_HW), generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    xy = rng.uniform(0, [OFFLINE_SMALL_HW[1] - 8, OFFLINE_SMALL_HW[0] - 8], (64, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(8, 100, (64, 2))], 1)
                            .astype(np.float32))
    with torch.inference_mode():
        feats = (f32.features(x.cuda()), cpu.features(x))
        rpn = (f32.rpn_head(feats[0]), cpu.rpn_head(feats[1]))
        casc = (f32.cascade(feats[0], rois.cuda(), OFFLINE_SMALL_HW)[1],
                cpu.cascade(feats[1], rois, OFFLINE_SMALL_HW)[1])
    fpn_err = max(rel_err(g, w) for g, w in zip(*feats))
    rpn_err = max(rel_err(g, w) for (gc, gr), (wc, wr) in zip(*rpn) for g, w in ((gc, wc), (gr, wr)))
    casc_err = float((casc[0].cpu() - casc[1]).abs().max())
    print(f"offline instances [{card}]: float32 card against CPU at {OFFLINE_SMALL_HW[0]}x"
          f"{OFFLINE_SMALL_HW[1]} (TF32 off): FPN maps {fpn_err:.3e}, RPN scores and deltas "
          f"{rpn_err:.3e} of their largest magnitudes (tol {OFFLINE_REL_TOL:g}); cascade class "
          f"probabilities of 64 fixed rois {casc_err:.3e} (tol {OFFLINE_PROB_TOL:g})")
    check(fpn_err <= OFFLINE_REL_TOL and rpn_err <= OFFLINE_REL_TOL
          and casc_err <= OFFLINE_PROB_TOL, "the detector on the card differs from the CPU")
    del model, f32, cpu
    torch.cuda.empty_cache()


def offline_train(root, tree, card):
    """Phase 10c: main_train on the tree's new side files, 2 steps and the
    closing validation of its 2 eval frames. Returns the launches."""
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.train import driver

    data = str(tree)
    args = parse_cli(TrainArgParser(), [
        OFFLINE_PARAMS_FILE, "--bs", "2", "--epochs", "1", "--validate_every", "1000",
        "--root", str(root / "runs_offline"), "--data_path", data, "--gt_path", data,
        "--filenames_file", str(tree / "train.txt"), "--data_path_eval", data,
        "--gt_path_eval", data, "--filenames_file_eval", str(tree / "eval.txt")])
    seen = {"loss": []}
    real = driver.make_train_step

    def make_train_step(*a, **k):
        step = real(*a, **k)

        def watched(state, batch):
            seen.setdefault("batch", batch)
            state, metrics = step(state, batch)
            seen["loss"].append(float(metrics["loss"]))
            return state, metrics

        return watched

    driver.make_train_step = make_train_step
    reset_counts()
    try:
        state = driver.main_train(args, max_steps=2, interactive=False)
    finally:
        driver.make_train_step = real
    counts = read_counts()
    batch = seen["batch"]
    sem_embedder, inst_embedder = cue_embedders(args)
    with torch.no_grad():
        _, sem = sem_embedder(batch["semantics"])
        _, inst, areas = inst_embedder(batch["instance_labels"], batch["instance_areas"])
    found = {"semantic classes": int(batch["semantics"].unique().numel()),
             "instance pixels": int((batch["instance_labels"] >= 0).sum()),
             "semantic channels' largest": float(sem.abs().max()),
             "instance channels' largest": float(inst.abs().max()),
             "area channel's largest": float(areas[:, :1].abs().max())}
    # bf16: 2 steps, the validation's frames and 2 figures, with the cue
    # columns (steps 0 and 2)
    expected = {"bins_head_fwd": 0, "bins_head_bwd": 0,
                "bins_head_tc_fwd": 2 + OFFLINE_EVAL_FRAMES + 2, "bins_head_tc_bwd": 4,
                "chamfer": 2, "chamfer_wide": 0}
    print(f"offline -> training [{card}]: {OFFLINE_PARAMS_FILE} --bs 2 on the generated side "
          f"files: {state.step} steps, losses {seen['loss']}, first batch {found}; launches "
          f"{counts}, expected {expected}")
    check(state.step == 2 and all(np.isfinite(seen["loss"])), "the cue training did not step")
    check(all(v > 0 for v in found.values()) and found["semantic classes"] > 1,
          f"a cue channel of the generated files is empty: {found}")
    check(counts == expected, f"cue training launches {counts}")
    del state
    torch.cuda.empty_cache()
    return counts


def offline(root, card):
    """Phase 10: the offline cue generators from the NYU frame to a cue
    configuration's training; `card` is nvidia-smi's name and power limit.
    Returns the launches of its training run."""
    tree = root / "offline"
    nyu_tree(tree, OFFLINE_TRAIN_FRAMES, OFFLINE_EVAL_FRAMES)
    t0 = time.perf_counter()
    reset_counts()
    offline_semantics(tree, card)
    offline_instances(tree, card)
    generators = read_counts()
    print(f"offline [{card}]: launches of the port's kernels by the two generators and "
          f"their checks: {generators} (no TPU kernel lies on the offline path)")
    check(not any(generators.values()), "an offline generator launched a port kernel")
    counts = offline_train(root, tree, card)
    print(f"offline [{card}]: phase 10 in {time.perf_counter() - t0:.1f} s")
    return counts


# --- phase 11: offline training and evaluation ----------------------------------

COCO_FRAMES, COCO_CLASSES = 8, 100
DET_WARMUP, DET_TIMED = 2, 8
DET_SMALL_SCALE = (256, 352)  # card against CPU, float32, TF32 off
# rois a stage in the card-against-CPU step (the CLI samples 512): the CPU's
# share of the phase is the mask heads' convolutions over them
DET_COMPARE_SAMPLES = 128
DET_LOSS_RTOL = 1e-3          # card vs CPU, float32; remat vs not, bf16
DET_BN_TOL = 1e-4             # card vs CPU: the bbox heads' BN stats, relative
DET_REMAT_SCALE = (800, 1333)  # the policy's largest scale: 800x1067, padded 800x1088
HRNET_TRAIN_BATCH, HRNET_TRAIN_HW = 2, (480, 640)
HRNET_STEP_HW = (128, 192)    # card against CPU
HRNET_LOSS_RTOL, HRNET_BN_TOL = 1e-4, 1e-4
SEMSEG_FRAMES = 4


def rle_counts(mask):
    """Uncompressed COCO RLE of a (h, w) {0, 1} mask: column-major runs,
    starting with a run of zeros."""
    flat = mask.T.reshape(-1).astype(np.int8)
    cuts = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], cuts, [flat.size]]))
    return ([0] if flat[0] else []) + [int(r) for r in runs]


_SEEDED = {}


def seeded_once(factory, seed, key):
    """`seeded(factory, seed)` with the draws made once per (key, seed): a
    later call builds `factory()` on the meta device and takes a copy of the
    first call's tensors (drawing Swin-B's 145 M weights takes the host
    seconds)."""
    from mde_tpu_torch.offline.layers import load_checked, seeded
    if (key, seed) not in _SEEDED:
        model = seeded(factory, seed)
        _SEEDED[key, seed] = {k: v.clone() for k, v in model.state_dict().items()}
        return model
    with torch.device("meta"):
        model = factory()
    state = {k: v.clone() for k, v in _SEEDED[key, seed].items()}
    return load_checked(model, state, f"seeded {key}").eval()


def coco_tree(root):
    """COCO_FRAMES copies of CLASSROOM and one instances json over
    COCO_CLASSES classes: per frame two polygons of two parts with float
    vertices, two uncompressed RLE masks, two bbox-only boxes, a crowd region
    and a box under 1 px wide. Returns the json's path."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    h, w = FRAME_HW
    yy, xx = np.mgrid[:h, :w]
    images, anns = [], []
    for i in range(COCO_FRAMES):
        shutil.copyfile(CLASSROOM, root / f"{i:05d}.jpg")
        images.append({"id": i, "file_name": f"{i:05d}.jpg", "height": h, "width": w})
        for j in range(6):
            x, y = rng.uniform(0, [w - 220, h - 170])
            bw, bh = rng.uniform(40, 220), rng.uniform(30, 170)
            ann = {"id": len(anns), "image_id": i, "iscrowd": 0, "bbox": [x, y, bw, bh],
                   "category_id": int(rng.integers(1, COCO_CLASSES + 1))}
            if j % 3 == 0:
                ann["segmentation"] = [[x, y, x + bw, y + 0.2 * bh, x + 0.5 * bw, y + bh],
                                       [x + 0.1 * bw, y + 0.6 * bh, x + 0.4 * bw, y + 0.7 * bh,
                                        x + 0.2 * bw, y + 0.95 * bh]]
            elif j % 3 == 1:
                inside = (((xx + 0.5 - x - bw / 2) / (bw / 2)) ** 2
                          + ((yy + 0.5 - y - bh / 2) / (bh / 2)) ** 2) <= 1
                ann["segmentation"] = {"size": [h, w], "counts": rle_counts(inside)}
            anns.append(ann)
        anns.append({"id": len(anns), "image_id": i, "iscrowd": 1, "category_id": 1,
                     "bbox": [0, 0, 50, 50], "segmentation": [[0, 0, 50, 0, 50, 50]]})
        anns.append({"id": len(anns), "image_id": i, "iscrowd": 0, "category_id": 2,
                     "bbox": [10, 10, 0.8, 30]})
    path = root / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": c, "name": f"class{c}"} for c in range(1, COCO_CLASSES + 1)]}))
    return path


def recorded_uniform(device):
    """(uniform(n) drawing on the CPU and handing a copy to `device`, the draws)."""
    gen, draws = torch.Generator().manual_seed(SEED), []

    def uniform(n):
        draws.append(torch.rand(n, generator=gen))
        return draws[-1].to(device)

    return uniform, draws


def replayed_uniform(draws, device):
    it = iter(draws)
    return lambda n: next(it).to(device)


def bbox_bn_stats(model):
    return [t.detach().float().cpu() for head in model.roi_head.bbox_head
            for conv in head.shared_convs for t in (conv.bn.running_mean, conv.bn.running_var)]


def train_detector_cli(tree, ann, out, card, profile_dir):
    """Phase 11a: train_detector.main in process: 2 + 8 steps of the seeded
    full-width detector (bf16, use_checkpoint) on the COCO tree under the
    full AutoAugment scale set; then the split of one step at 800x1088.
    Returns the checkpoint's path."""
    from mde_tpu_torch.offline import train_detector as td
    from mde_tpu_torch.offline.cascade_rcnn import load_detector

    times, ends, losses, sizes, events, saves = [], [], [], [], [], []
    real_step, real_save = td.train_step, td.save_checkpoint

    def step(model, opt, sched, sample, uniform, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(times) == DET_WARMUP - 1:  # the last warm-up step, under the profiler
            out, n, busy, wall, prof = profiled(lambda: real_step(model, opt, sched, sample,
                                                                  uniform))
            events.append((n, busy, wall, top_device_ops(prof), tuple(sample["image"].shape[:2])))
            write_profile(profile_dir, "detector_step", op_table(prof),
                          op_table(prof, sort_by="self_cpu_time_total"))
        else:
            out = real_step(model, opt, sched, sample, uniform, *a, **k)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        times.append((ends[-1] - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
        sizes.append(tuple(sample["image"].shape[:2]))
        if len(times) == DET_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        return out

    def save(path, *a):
        t0 = time.perf_counter()
        real_save(path, *a)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))

    td.train_step, td.save_checkpoint = step, save
    reset_counts()
    try:
        t0 = time.perf_counter()
        model = td.main(["--images", str(tree), "--annotations", str(ann), "--num-classes",
                         str(COCO_CLASSES), "--epochs", "2", "--max-steps",
                         str(DET_WARMUP + DET_TIMED), "--log-every", "1", "--save-every",
                         "1000000", "--max-gt", "100", "--out", str(out)])
        seconds = time.perf_counter() - t0
    finally:
        td.train_step, td.save_checkpoint = real_step, real_save
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    timed = times[DET_WARMUP:]
    walls = frame_walls(ends[DET_WARMUP - 1:])
    print(f"train_detector [{card}]: {len(times)} steps in {seconds:.1f} s; Swin-B Cascade Mask "
          f"R-CNN, {COCO_CLASSES} classes, bf16 from float32 masters, use_checkpoint, one image a "
          f"step, padded sizes {sorted(set(sizes))}: step median {statistics.median(timed):.3f} "
          f"ms (min {min(timed):.3f}, max {max(timed):.3f}) over {len(timed)}; step to step "
          f"with the host's decode, AutoAugment and GT padding {statistics.median(walls):.3f} "
          f"ms; peak {peak} bytes after warm-up; checkpoint saves (s, bytes) {saves}")
    n, busy, wall, top, hw = events[0]
    print(f"train_detector [{card}]: the profiled warm-up step at {hw[0]}x{hw[1]}: {n} device "
          f"events, device busy {busy:.1f} of {wall:.1f} ms ({100 * busy / wall:.1f} %); most "
          f"device time: {top}")
    print(f"train_detector [{card}]: losses " + json.dumps(
        [{k: round(v, 5) for k, v in l.items()} for l in losses]))
    check(len(times) == DET_WARMUP + DET_TIMED, f"train_detector took {len(times)} steps")
    check(all(np.isfinite(list(l.values())).all() for l in losses), "a detector loss is not finite")
    check(not any(counts.values()), f"train_detector launched a port kernel: {counts}")
    check(len(set(sizes)) > 1 and all(480 <= h <= 800 for h, _ in sizes),
          f"AutoAugment's padded sizes: {sizes}")
    path = out / "detector_latest.pth"
    loaded = load_detector(str(path), num_classes=COCO_CLASSES).state_dict()
    mine = model.state_dict()
    check(set(loaded) == set(mine) and all(torch.equal(loaded[k], v.cpu())
                                           for k, v in mine.items()),
          "the written checkpoint does not load back through load_detector")
    print(f"train_detector [{card}]: {path.name} ({os.path.getsize(path)} bytes) loads strictly "
          f"through load_detector, every tensor equal")
    detector_split(model, tree, ann, card)
    del model
    torch.cuda.empty_cache()
    return path


def detector_split(model, tree, ann, card):
    """The split of one bf16 step at 800x1088 (synchronized around each part,
    after one step that creates the AdamW state)."""
    from mde_tpu_torch.offline import cascade_rcnn, detection_train
    from mde_tpu_torch.offline import train_detector as td
    from mde_tpu_torch.offline.coco_dataset import CocoInstanceDataset
    from mde_tpu_torch.offline.detection_data import detector_optimizer, fixed_scales
    from mde_tpu_torch.offline.detection_train import generator_uniform

    sample = CocoInstanceDataset(str(tree), str(ann)).train_sample(
        np.random.default_rng(SEED), 0, max_gt=100, scales=fixed_scales(*DET_REMAT_SCALE))
    opt, sched = detector_optimizer(model, steps_per_epoch=COCO_FRAMES)
    uniform = generator_uniform(torch.Generator(device="cuda").manual_seed(SEED))
    td.train_step(model, opt, sched, sample, uniform)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    clock = Clock()
    for name in ("features", "proposals"):
        clock.wrap(model, name)
    for name in ("rpn_loss", "rcnn_stage_targets", "mask_targets"):
        clock.wrap(detection_train, name)
    clock.wrap(cascade_rcnn, "extract_roi_features")
    image, img_hw = put(sample["image"]).permute(2, 0, 1)[None], tuple(sample["valid_hw"])
    try:
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_masks = max(int(sample["gt_valid"].sum()), 1)
        losses = model.compute_losses(
            image, put(sample["gt_boxes"]), put(sample["gt_labels"]).long(),
            put(sample["gt_valid"]), put(sample["gt_masks"][:n_masks]), uniform, img_hw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        clock.restore()
        for name in ("features", "proposals"):
            delattr(model, name)
    losses["total"].backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    parts = ", ".join(f"{k} {sum(v):.1f} ms ({len(v)} calls)" for k, v in clock.times.items())
    print(f"train_detector [{card}]: split of one step at {sample['image'].shape[0]}x"
          f"{sample['image'].shape[1]} (synchronized around each part): compute_losses "
          f"{1e3 * (t1 - t0):.1f} ms, of it {parts}; backward {1e3 * (t2 - t1):.1f} ms (the Swin "
          f"blocks recomputed, RoIAlign's scatter); AdamW {1e3 * (t3 - t2):.1f} ms")
    del opt
    proposals_with_and_without_grad(model, image, img_hw, card)


def proposals_with_and_without_grad(model, image, img_hw, card):
    """The RPN's proposals of one 800x1088 frame from features that carry a
    graph, without autograd's record (as compute_losses runs them) and with
    it, alternating, synchronized: the record's cost on the host."""
    feats = model.features(image)
    rpn_outs = model.rpn_head(feats)

    def proposals_ms(grad):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(grad):
            model.proposals(feats, img_hw, rpn_outs)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    times = {False: [], True: []}
    for _ in range(3):
        for grad in (False, True):
            times[grad].append(proposals_ms(grad))
    print(f"train_detector [{card}]: the proposals alone at {image.shape[2]}x{image.shape[3]}, "
          f"median of 3 alternating: {statistics.median(times[False]):.1f} ms without autograd's "
          f"record, {statistics.median(times[True]):.1f} ms with it (all: "
          f"{[round(t, 1) for t in times[False]]}, {[round(t, 1) for t in times[True]]})")


def detector_card_vs_cpu(tree, ann, card):
    """Phase 11b: one float32 step at a fixed 256x352 scale on the card and on
    the CPU, the same sample and sampler draws: losses and the bbox heads'
    BN stats."""
    from mde_tpu_torch.offline import train_detector as td
    from mde_tpu_torch.offline.cascade_rcnn import CascadeMaskRCNN
    from mde_tpu_torch.offline.coco_dataset import CocoInstanceDataset
    from mde_tpu_torch.offline.detection_data import detector_optimizer, fixed_scales

    ds = CocoInstanceDataset(str(tree), str(ann))
    sample = ds.train_sample(np.random.default_rng(SEED), 0, max_gt=100,
                             scales=fixed_scales(*DET_SMALL_SCALE))
    result = {}
    uniform, draws = recorded_uniform("cpu")
    for device in ("cpu", "cuda"):
        model = seeded_once(lambda: CascadeMaskRCNN(COCO_CLASSES), SEED,
                            f"detector {COCO_CLASSES}").to(device).train()
        opt, sched = detector_optimizer(model, steps_per_epoch=COCO_FRAMES)
        t0 = time.perf_counter()
        losses = td.train_step(model, opt, sched, sample,
                               uniform if device == "cpu" else replayed_uniform(draws, device),
                               num_samples=DET_COMPARE_SAMPLES)
        result[device] = ({k: float(v) for k, v in losses.items()}, bbox_bn_stats(model),
                          time.perf_counter() - t0)
        del model, opt
    (l_cpu, s_cpu, t_cpu), (l_gpu, s_gpu, t_gpu) = result["cpu"], result["cuda"]
    loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-30) for k in l_cpu)
    bn_err = max(max_rel(g, c) for g, c in zip(s_gpu, s_cpu))
    print(f"train_detector [{card}]: one float32 step at {sample['image'].shape[0]}x"
          f"{sample['image'].shape[1]}, {DET_COMPARE_SAMPLES} rois a stage, the same draws, card "
          f"against CPU (TF32 off): losses {json.dumps({k: round(v, 6) for k, v in l_gpu.items()})}"
          f", largest relative difference {loss_err:.3e} (tol {DET_LOSS_RTOL:g}); the bbox heads' "
          f"updated BN stats {bn_err:.3e} (tol {DET_BN_TOL:g}); step {1e3 * t_gpu:.1f} ms on the "
          f"card (first, cold), {t_cpu:.1f} s on the CPU")
    check(loss_err <= DET_LOSS_RTOL and bn_err <= DET_BN_TOL,
          "the detector's step on the card differs from the CPU")
    torch.cuda.empty_cache()


def detector_remat(tree, ann, card):
    """Phase 11c: one bf16 step at the policy's largest scale with and
    without use_checkpoint, the same draws: the losses and the peaks."""
    from mde_tpu_torch.offline import train_detector as td
    from mde_tpu_torch.offline.cascade_rcnn import CascadeMaskRCNN
    from mde_tpu_torch.offline.coco_dataset import CocoInstanceDataset
    from mde_tpu_torch.offline.detection_data import detector_optimizer, fixed_scales
    from mde_tpu_torch.offline.layers import cast_at_use

    ds = CocoInstanceDataset(str(tree), str(ann))
    sample = ds.train_sample(np.random.default_rng(SEED), 0, max_gt=100,
                             scales=fixed_scales(*DET_REMAT_SCALE))
    uniform, draws = recorded_uniform("cuda")
    result = {}
    for remat in (True, False):
        model = seeded_once(lambda: CascadeMaskRCNN(COCO_CLASSES, use_checkpoint=remat), SEED,
                            f"detector {COCO_CLASSES}")
        model = cast_at_use(model, torch.bfloat16).cuda().train()
        opt, sched = detector_optimizer(model, steps_per_epoch=COCO_FRAMES)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = td.train_step(model, opt, sched, sample,
                               uniform if remat else replayed_uniform(draws, "cuda"))
        torch.cuda.synchronize()
        result[remat] = ({k: float(v) for k, v in losses.items()},
                         torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0)
        del model, opt
        torch.cuda.empty_cache()
    (l_r, p_r, t_r), (l_n, p_n, t_n) = result[True], result[False]
    err = max(abs(l_r[k] - l_n[k]) / max(abs(l_n[k]), 1e-30) for k in l_n)
    print(f"train_detector [{card}]: one bf16 step at {sample['image'].shape[0]}x"
          f"{sample['image'].shape[1]} with use_checkpoint against without, the same draws: "
          f"losses' largest relative difference {err:.3e} (tol {DET_LOSS_RTOL:g}); peak above "
          f"the model {p_r} against {p_n} bytes; {1e3 * t_r:.1f} against {1e3 * t_n:.1f} ms "
          f"(first steps, cold)")
    check(err <= DET_LOSS_RTOL, "use_checkpoint changes the detector's losses")
    check(p_r < p_n, "use_checkpoint does not lower the detector's peak")


def eval_detector_cli(tree, ann, ckpt, card):
    """Phase 11d: eval_detector.main on the COCO tree with phase 11a's checkpoint."""
    from mde_tpu_torch.offline import eval_detector as ed

    clock = Clock()
    clock.wrap(ed, "detect", "frame")
    try:
        t0 = time.perf_counter()
        summary = ed.main(["--images", str(tree), "--annotations", str(ann), "--checkpoint",
                           str(ckpt), "--num-classes", str(COCO_CLASSES), "--score-thr",
                           str(OFFLINE_SCORE_THR)])
        seconds = time.perf_counter() - t0
    finally:
        clock.restore()
    frames = clock.times["frame"]
    print(f"eval_detector [{card}]: {len(frames)} frames of {FRAME_HW[0]}x{FRAME_HW[1]} in "
          f"{seconds:.1f} s (checkpoint load included), bf16, --score-thr {OFFLINE_SCORE_THR}: "
          f"detect {statistics.median(frames[1:]):.3f} ms a frame after the first (first "
          f"{frames[0]:.3f}); " + json.dumps(summary))
    check(set(summary) == {"bbox_mAP", "bbox_mAP50", "segm_mAP", "segm_mAP50"},
          f"eval_detector printed {sorted(summary)}")
    check(all(np.isnan(v) or 0.0 <= v <= 1.0 for v in summary.values()),
          f"eval_detector's metrics out of range: {summary}")


def hrnet_training(card, profile_dir):
    """Phase 11e: HRNetV2-W48 + C1 training steps at full width on the card,
    and one step card against CPU."""
    from mde_tpu_torch.offline.hrnet import HRNetV2C1
    from mde_tpu_torch.offline.hrnet_train import build_semseg_optimizer, make_semseg_train_step

    def batch(hw, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((HRNET_TRAIN_BATCH, 3, *hw), generator=g)
        labels = torch.randint(0, 150, (HRNET_TRAIN_BATCH, hw[0] // 4, hw[1] // 4), generator=g)
        labels[:, 0], labels[:, -1], labels[:, :, 0], labels[:, :, -1] = -1, -1, -1, -1
        return x, labels

    torch.cuda.empty_cache()
    model = seeded_once(HRNetV2C1, SEED, "hrnet").cuda()
    opt, sched = build_semseg_optimizer(model)
    step = make_semseg_train_step(model, opt, sched)
    x, labels = (t.cuda() for t in batch(HRNET_TRAIN_HW, SEED))
    times, losses = [], []
    for i in range(DET_WARMUP + DET_TIMED):
        if i == DET_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(x, labels)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    _, events, busy, wall, prof = profiled(lambda: step(x, labels))
    write_profile(profile_dir, "hrnet_step", op_table(prof),
                  op_table(prof, sort_by="self_cpu_time_total"))
    timed = times[DET_WARMUP:]
    print(f"hrnet train [{card}]: HRNetV2-W48 + C1, 150 classes, float32 (TF32 off), batch "
          f"{HRNET_TRAIN_BATCH} of {HRNET_TRAIN_HW[0]}x{HRNET_TRAIN_HW[1]}, SGD + poly, one fixed "
          f"batch: step median {statistics.median(timed):.3f} ms (min {min(timed):.3f}, max "
          f"{max(timed):.3f}) over {len(timed)}; peak {peak} bytes; losses "
          f"{[round(v, 5) for v in losses]}; a profiled step: {events} device events, device "
          f"busy {busy:.1f} of {wall:.1f} ms ({100 * busy / wall:.1f} %); most device time: "
          f"{top_device_ops(prof)}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "HRNet's loss did not fall over its steps")
    del model, opt, step
    torch.cuda.empty_cache()

    x, labels = batch(HRNET_STEP_HW, SEED + 1)
    out = {}
    for device in ("cpu", "cuda"):
        m = seeded_once(HRNetV2C1, SEED, "hrnet").to(device)
        o, s = build_semseg_optimizer(m)
        metrics = make_semseg_train_step(m, o, s)(x.to(device), labels.to(device))
        out[device] = (float(metrics["loss"]), [b.detach().float().cpu() for n, b in
                                                m.named_buffers() if "running_" in n])
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    bn_err = max(max_rel(g, c) for g, c in zip(out["cuda"][1], out["cpu"][1]))
    print(f"hrnet train [{card}]: one step at {HRNET_STEP_HW[0]}x{HRNET_STEP_HW[1]}, card "
          f"against CPU: loss {out['cuda'][0]:.6f} against {out['cpu'][0]:.6f} ({loss_err:.3e}, "
          f"tol {HRNET_LOSS_RTOL:g}); {len(out['cpu'][1])} BN buffers, largest relative "
          f"difference {bn_err:.3e} (tol {HRNET_BN_TOL:g})")
    check(loss_err <= HRNET_LOSS_RTOL and bn_err <= HRNET_BN_TOL,
          "HRNet's step on the card differs from the CPU")
    torch.cuda.empty_cache()


def eval_semseg_cli(root, card):
    """Phase 11f: eval_semseg.main on an odgt of SEMSEG_FRAMES NYU frames with
    seeded CSAIL-named checkpoints and --result-dir."""
    from mde_tpu_torch.data.decode import read_png, write_png
    from mde_tpu_torch.offline import eval_semseg as es
    from mde_tpu_torch.offline.hrnet import HRNetV2C1, hrnet_multiscale_inference

    root.mkdir(parents=True)
    model = seeded_once(HRNetV2C1, SEED, "hrnet")
    torch.save(model.encoder.state_dict(), root / "encoder_epoch_30.pth")
    torch.save(model.decoder.state_dict(), root / "decoder_epoch_30.pth")
    yy, xx = np.mgrid[:FRAME_HW[0], :FRAME_HW[1]]
    lines = []
    for i in range(SEMSEG_FRAMES):
        shutil.copyfile(CLASSROOM, root / f"frame_{i}.jpg")
        write_png(root / f"frame_{i}.png", ((yy // 40 * 13 + xx // 40 * 7 + i) % 151)
                  .astype(np.uint8))
        lines.append(json.dumps({"fpath_img": f"frame_{i}.jpg", "fpath_segm": f"frame_{i}.png"}))
    (root / "val.odgt").write_text("\n".join(lines) + "\n")
    seen, preds = {}, []
    real_build, real_segment = es.build_model, es.segment

    def build(args, device):
        seen["model"] = real_build(args, device)
        return seen["model"]

    def segment(m, img):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = real_segment(m, img)
        preds.append((img, pred, (time.perf_counter() - t0) * 1e3))
        return pred

    es.build_model, es.segment = build, segment
    try:
        result = es.main(["--odgt", str(root / "val.odgt"), "--root", str(root), "--encoder-ckpt",
                          str(root / "encoder_epoch_30.pth"), "--decoder-ckpt",
                          str(root / "decoder_epoch_30.pth"), "--result-dir", str(root / "vis")])
    finally:
        es.build_model, es.segment = real_build, real_segment
    device = next(seen["model"].parameters()).device
    for img, pred, _ in preds:
        with torch.inference_mode():
            direct = hrnet_multiscale_inference(lambda x, s: seen["model"](x.to(device), s), img)
        check(np.array_equal(direct, pred), "eval_semseg's prediction differs from a direct call")
    grids = [read_png(root / "vis" / f"frame_{i}.png") for i in range(SEMSEG_FRAMES)]
    check(all(g.shape == (FRAME_HW[0], 3 * FRAME_HW[1], 3) for g in grids),
          f"eval_semseg's grids: {[g.shape for g in grids]}")
    print(f"eval_semseg [{card}]: {SEMSEG_FRAMES} frames of {FRAME_HW[0]}x{FRAME_HW[1]}, bf16, "
          f"five scales: segment {statistics.median(p[2] for p in preds[1:]):.3f} ms a frame "
          f"after the first; each prediction equal to a direct hrnet_multiscale_inference call; "
          f"mIoU {result['mIoU']:.4f}, accuracy {result['accuracy']:.2f}%; {len(grids)} RGB "
          f"grids of {grids[0].shape}")
    check(np.isfinite(result["mIoU"]) and 0 <= result["accuracy"] <= 100,
          "eval_semseg's metrics are not finite")
    del seen
    torch.cuda.empty_cache()


def offline_training(root, card, profile_dir):
    """Phase 11: the offline training and evaluation of the cue generators,
    seeded weights at full width; no port kernel lies on this path. With
    --profile, the profiled detector and HRNet steps' tables go to DIR."""
    t0 = time.perf_counter()
    seconds = {}

    def part(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    tree = root / "coco"
    ann = part("coco tree", coco_tree, tree)
    reset_counts()
    ckpt = part("a", train_detector_cli, tree, ann, root / "runs_detector", card, profile_dir)
    part("b", detector_card_vs_cpu, tree, ann, card)
    part("c", detector_remat, tree, ann, card)
    part("d", eval_detector_cli, tree, ann, ckpt, card)
    part("e", hrnet_training, card, profile_dir)
    part("f", eval_semseg_cli, root / "semseg", card)
    counts = read_counts()
    print(f"offline training [{card}]: launches of the port's kernels: {counts} (no TPU kernel "
          f"lies on this path); phase 11 in {time.perf_counter() - t0:.1f} s, of it (s) "
          f"{seconds}")
    check(not any(counts.values()), f"offline training launched a port kernel: {counts}")
    _SEEDED.clear()


# --- phase 12: the semantic-segmentation zoo and the infer demo --------------

# CSAIL's published ADE20K combinations that the JAX zoo builds
# (mde_tpu/offline/semseg_zoo.py), plus resnext101-upernet
ZOO = (("resnet18dilated", "ppm_deepsup"), ("resnet50dilated", "ppm_deepsup"),
       ("resnet101dilated", "ppm_deepsup"), ("mobilenetv2dilated", "c1_deepsup"),
       ("resnet18dilated", "c1_deepsup"), ("resnet50", "upernet"), ("resnet101", "upernet"),
       ("resnext101", "upernet"))
ZOO_CLASSES = 150
ZOO_SMALL_HW = (128, 160)  # the card against the CPU, float32
ZOO_TOL = 1e-4  # of the largest CPU log-probability
ZOO_STEP_ARCH = ("resnet50dilated", "ppm_deepsup")
ZOO_STEPS = 5


def nyu_frame():
    """The repo's NYU frame, normalised, (1, 3, 480, 640) float32 on the card."""
    from mde_tpu_torch.data import read_rgb
    from mde_tpu_torch.data.transforms import normalize_image
    img = normalize_image(read_rgb(CLASSROOM).astype(np.float32) / 255.0)
    return torch.from_numpy(img).permute(2, 0, 1)[None].contiguous().cuda()


def zoo_forwards(card):
    """Phase 12a: each ZOO model at its published widths, 150 classes,
    seeded weights: float32 card against CPU at ZOO_SMALL_HW, then bf16
    (`to_compute_dtype`, as generate_semantics) on the NYU frame: ms a frame
    (synchronized, median of 5 after a warm-up), device events, peak."""
    from mde_tpu_torch.offline.layers import seeded, to_compute_dtype
    from mde_tpu_torch.offline.semseg_zoo import SegmentationModel

    frame = nyu_frame()
    small = torch.randn((1, 3, *ZOO_SMALL_HW), generator=torch.Generator().manual_seed(SEED))
    rows = {}
    for arch in ZOO:
        model = seeded(lambda: SegmentationModel(*arch, ZOO_CLASSES), SEED)
        n_params = sum(p.numel() for p in model.parameters())
        with torch.no_grad():
            want = model(small)
            got = model.cuda()(small.cuda())
        err = rel_err(got, want)
        check(torch.isfinite(got).all().item() and err <= ZOO_TOL,
              f"zoo {'-'.join(arch)}: card against CPU {err:.3e}")
        model = to_compute_dtype(model, torch.bfloat16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def forward():
            with torch.inference_mode():
                return model(frame, seg_size=FRAME_HW)

        scores = forward()  # warm-up: cuDNN's heuristics
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = forward()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        events, _ = device_event_count(forward)
        check(scores.shape == (1, ZOO_CLASSES, *FRAME_HW) and torch.isfinite(scores).all().item()
              and abs(scores.sum(1).mean().item() - 1) < 1e-3,
              f"zoo {'-'.join(arch)}: the bf16 scores")
        rows["-".join(arch)] = (statistics.median(ms), events, peak)
        print(f"zoo [{card}]: {'-'.join(arch)}, {n_params} parameters: float32 card against "
              f"CPU at {ZOO_SMALL_HW[0]}x{ZOO_SMALL_HW[1]} {err:.3e} (tolerance {ZOO_TOL}); "
              f"bf16 at {FRAME_HW[0]}x{FRAME_HW[1]}: median {statistics.median(ms):.3f} ms a "
              f"frame (all: {', '.join(f'{v:.3f}' for v in ms)}), {events} device events, "
              f"peak {peak} bytes above the weights")
        del model, scores
        torch.cuda.empty_cache()
    return rows


def zoo_train_step(card):
    """Phase 12b: make_semseg_train_step of resnet50dilated + ppm_deepsup,
    float32, batch 2 of 480x640, labels at 60x80 with a -1 border, SGD +
    poly, ZOO_STEPS steps on one batch: finite, the last loss below the
    first; step ms, peak, a profiled step's busy share."""
    from mde_tpu_torch.offline.hrnet_train import build_semseg_optimizer, make_semseg_train_step
    from mde_tpu_torch.offline.layers import seeded
    from mde_tpu_torch.offline.semseg_zoo import SegmentationModel

    g = torch.Generator().manual_seed(SEED)
    x = torch.randn((2, 3, *FRAME_HW), generator=g).cuda()
    labels = torch.randint(0, ZOO_CLASSES, (2, FRAME_HW[0] // 8, FRAME_HW[1] // 8),
                           generator=g).cuda()
    labels[:, 0] = -1
    model = seeded(lambda: SegmentationModel(*ZOO_STEP_ARCH, ZOO_CLASSES), SEED).cuda()
    opt, sched = build_semseg_optimizer(model)
    step = make_semseg_train_step(model, opt, sched)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(ZOO_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(x, labels)["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    _, n_events, busy_ms, wall_ms, _ = profiled(lambda: step(x, labels)["loss"].item())
    print(f"zoo step [{card}]: {'-'.join(ZOO_STEP_ARCH)}, float32, batch 2 of "
          f"{FRAME_HW[0]}x{FRAME_HW[1]}: losses {[round(v, 6) for v in losses]}; step ms "
          + ", ".join(f"{v:.3f}" for v in ms) + f" (median of steps 2-{ZOO_STEPS} "
          f"{statistics.median(ms[1:]):.3f}); peak {peak} bytes; a profiled step: wall "
          f"{wall_ms:.3f} ms, device busy {100 * busy_ms / wall_ms:.1f}%, {n_events} device "
          f"events")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"zoo step: the loss did not fall: {losses}")
    del model, opt, step
    torch.cuda.empty_cache()


def infer_demo(root, gen, card):
    """Phase 12c: `predict_pil(visualized=True)` and `python -m
    mde_tpu_torch.infer` on the NYU frame with a seeded checkpoint in the
    layout the demo loads ({"model": state_dict}); both write their picture
    with no matplotlib: the colorized (480, 640, 3) uint8 array, and
    ./thingy.png of the frame's size in the demo's working directory.
    Returns the launches of the in-process request."""
    from mde_tpu_torch.data import read_png, read_rgb
    from mde_tpu_torch.infer import InferenceHelper
    from mde_tpu_torch.models import UnetAdaptiveBins

    model = UnetAdaptiveBins(n_bins=N_BINS, min_val=1e-3, max_val=10.0,
                             encoder_name="efficientnet-b1", fused_head=True)
    out = root / "infer"
    out.mkdir()
    ckpt = out / "AdaBins_nyu_seeded.pt"
    torch.save({"model": seeded_state_dict(model, gen)}, ckpt)
    helper = InferenceHelper(dataset="nyu", checkpoint_path=str(ckpt), device="cuda")
    reset_counts()
    _, pred, viz = helper.predict_pil(read_rgb(CLASSROOM), visualized=True)
    counts = read_counts()
    check(viz.shape == (*FRAME_HW, 3) and viz.dtype == np.uint8 and pred.shape == (1, *FRAME_HW, 1)
          and np.isfinite(pred).all(), "predict_pil(visualized=True): the picture")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mde_tpu_torch.infer", str(CLASSROOM), str(ckpt)],
                          cwd=out, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=300)
    demo_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m mde_tpu_torch.infer: {proc.stderr[-2000:]}")
    png = read_png(out / "thingy.png")
    check(png.shape == (*FRAME_HW, 3) and png.dtype == np.uint8 and len(np.unique(png)) > 8,
          f"the demo's thingy.png: {png.shape} {png.dtype}")
    check("matplotlib" not in sys.modules, "the port imported matplotlib")
    print(f"infer [{card}]: predict_pil(visualized=True): {viz.shape} {viz.dtype}, launches "
          f"{counts}; python -m mde_tpu_torch.infer in {demo_s:.2f} s: "
          f"{proc.stdout.strip().splitlines()[-1]}; thingy.png {png.shape} {png.dtype}; "
          f"matplotlib installed {importlib.util.find_spec('matplotlib') is not None}, "
          f"imported False")
    check(counts == {**{k: 0 for k in counts}, "bins_head_fwd": 1},
          f"predict_pil launches {counts}")
    return counts


def semseg_zoo_and_demo(root, gen, card):
    """Phase 12; returns the launches of the demo's request."""
    t0 = time.perf_counter()
    zoo_forwards(card)
    zoo_train_step(card)
    counts = infer_demo(root, gen, card)
    print(f"zoo and demo [{card}]: phase 12 in {time.perf_counter() - t0:.1f} s")
    return counts


def only_tensor_parallel(gen, profile_dir, nccl_only):
    """--only tp: phase 5's steps (for the median beside) and phase 9e on a
    phase-8 tree; --only tp-nccl: phase 9e's NCCL ranks and their
    one-process reference alone. No kernels line and no result line."""
    from mde_tpu_torch.models import build_model
    flagship = flagship_args()
    model = build_model(flagship)
    state_dict = seeded_state_dict(model, gen)
    model.load_state_dict(state_dict, strict=True)
    train_ms = None
    if not nccl_only:
        _, train_ms, _ = train(flagship, model.cuda(), gen, None, "train")
    del model
    torch.cuda.empty_cache()
    build_dir = REPO / ".build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        root = Path(tmp)
        if not nccl_only:
            nyu_tree(root / "nyu")
        tensor_parallel(state_dict, root, train_ms, profile_dir is not None, gloo=not nccl_only)
    print(f"chip_smoke --only {'tp-nccl' if nccl_only else 'tp'}: phase 9e passed")
    return 0


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile requests under four cuDNN settings and the "
                             "training steps, and write the tables to DIR; print the cue "
                             "ops' share of the A step")
    parser.add_argument("--only", choices=["tp", "tp-nccl"], default=None,
                        help="tp: run the toolchain, the build, phase 5 and phase 9e only; "
                             "tp-nccl: the build and phase 9e's NCCL ranks only (two cards "
                             "or more)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    run_t0 = time.perf_counter()
    from mde_tpu_torch.data import native
    from mde_tpu_torch.kernels import bins_head, build, chamfer
    from mde_tpu_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)

    card = toolchain(build)
    build_all(build, {bins_head._SOURCE: bins_head.library,
                      bins_head._TC_SOURCE: bins_head.tc_library,
                      chamfer._SOURCE: chamfer.library, native.SOURCE: native.library})

    if args.only:
        return only_tensor_parallel(gen, args.profile, nccl_only=args.only == "tp-nccl")
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
    add(train_wide())
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
        add(tensor_parallel(state_dict, root, train_ms, args.profile is not None))
        add(offline(root, card))
        offline_training(root, card, args.profile)
        add(semseg_zoo_and_demo(root, gen, card))
    for (p, name), st in wide.items():
        print(f"chamfer_wide_kernel ({p} bins, {name}; on no params file's path: every one "
              f"has 256 bins): " + json.dumps(st))
    print(f"launches over the main paths (the float32 head backward from the step "
          f"checks): {launches}")
    print(f"chip_smoke: the whole run in {time.perf_counter() - run_t0:.1f} s [{card}]")
    check(all(launches.values()), f"a kernel was launched no time: {launches}")

    head = "mde_tpu/kernels/bins_head.py"
    rows = [("bins_head_fwd", "mde_tpu_torch/csrc/bins_head.cu", f"{head}:76", serving_fwd),
            ("bins_head_bwd", "mde_tpu_torch/csrc/bins_head.cu", f"{head}:84",
             bwd[torch.float32]),
            ("bins_head_tc_fwd", "mde_tpu_torch/csrc/bins_head_tc.cu", f"{head}:76",
             fwd[torch.bfloat16]),
            ("bins_head_tc_bwd", "mde_tpu_torch/csrc/bins_head_tc.cu", f"{head}:84",
             bwd[torch.bfloat16]),
            ("chamfer", "mde_tpu_torch/csrc/chamfer.cu", "mde_tpu/kernels/chamfer.py:48", cham),
            ("chamfer_wide", "mde_tpu_torch/csrc/chamfer.cu", "mde_tpu/kernels/chamfer.py:48",
             wide[WIDE_STEP_BINS, "noise"])]
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
