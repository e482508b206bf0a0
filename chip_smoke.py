#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`mde_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile DIR   # also write profiler tables to DIR

Phases, each of which ends the run with a non-zero exit if it fails:
  1. toolchain: torch, CUDA, nvcc, device capability, triton, card and power
  2. build the kernels of mde_tpu_torch/csrc with nvcc, one process per
     source, all at once (bins_head.cu: the float32 head forward and
     backward on the CUDA cores; bins_head_tc.cu: the bfloat16 head forward
     and backward on the tensor cores; chamfer.cu: chamfer reductions)
  3. each kernel against its plain PyTorch version: the head forward at the
     serving shape (B=2, 240x320 pixels) and, with the head backward, at the
     training shape (B=16, 208x272 pixels), 128 channels, 256 bins, float32
     (CUDA-core kernels) and bfloat16 (tensor-core kernels), the float32
     forward's share of its bound at both shapes; the bf16 kernels again at
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
  7. one JSON line on the kernels, then the result line.

float32 comparisons run with TF32 off for both cuDNN and cuBLAS. The script
imports no JAX: it is the quickest proof that the port runs on the card.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
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
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    print("toolchain: " + json.dumps(info))
    print(smi)
    return smi


def build_all(build, libraries):
    """Phase 2: one nvcc per source, started together; `libraries` maps each
    source to the function that builds and loads it."""
    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(libraries)) as pool:
        seconds = list(pool.map(timed, libraries.values()))
    for source, s in zip(libraries, seconds):
        print(f"build: {source} in {s:.2f} s (all sources built in parallel)")
        log = build.library_path(source).with_suffix(".log").read_text().strip()
        print(log)
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
        print(f"head forward {label} {dtype}: max_abs_err {abs_err:.3e} max_rel_err "
              f"{rel_err:.3e} (tolerance rtol=atol={tol}) kernel {ms:.4f} ms plain "
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
    the training shape; returns stats per dtype. The bf16 kernels read the
    forward's (max, sum), so their forward runs once, untimed, first."""
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
            backward = lambda: bins_head._launch_bwd(*args, upstream)
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
        print(f"head backward {dtype} (B={TRAIN_BATCH}, {args[0].shape[2]}x"
              f"{args[0].shape[3]}, {N_BINS} bins): " + ", ".join(
                  f"{k} max_abs_err {a:.3e} rel {r:.3e}" for k, (a, r) in errs.items())
              + f" (tolerance of the largest value: {tol}) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms")
        for name, (_, rel) in errs.items():
            check(rel <= tol[name], f"head backward {dtype} {name}: {rel:.3e} > {tol[name]}")
        x = args[0]
        pixels = x.shape[0] * x.shape[2] * x.shape[3]
        flops = 3 * 2 * pixels * 128 * N_BINS
        nbytes = 2 * x.numel() * x.element_size() + pixels * 4
        stats[dtype] = {"max_abs_err": max(a for a, _ in errs.values()), "ms": ms,
                        "plain_ms": plain_ms,
                        **bound(flops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS,
                                nbytes)}
        del plain_out, inputs, want, got, backward
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
    launches = counts["bins_head_fwd"]
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: {REQUESTS} requests of {FRAME_HW[0]}x{FRAME_HW[1]}, kernel launches "
          f"{launches}, median latency {statistics.median(latencies):.3f} ms "
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
    return launches


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
                use_instance_segmentation=None, image="rgb", w_chamfer=0.1, chamfer=True,
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


def train(state_dict, gen, profile_dir):
    """Phase 5: the flagship training step; returns the launches per kernel
    over the timed steps."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state, make_train_step

    args = flagship_args()
    model = build_model(args).cuda()
    model.load_state_dict(state_dict, strict=True)
    state = create_train_state(model, args, steps_per_epoch=2693)
    step = make_train_step(args)
    image = torch.randn((TRAIN_BATCH, 3, *TRAIN_HW), generator=gen).cuda()
    depth = (0.05 + 9.9 * torch.rand((TRAIN_BATCH, 1, *TRAIN_HW), generator=gen)).cuda()
    batch = {"image": image, "depth": depth}
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
    print(f"train: {TIMED_STEPS} steps after {WARMUP_STEPS} warm-up, batch {TRAIN_BATCH} of "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16 autocast: median step {median:.3f} ms "
          f"(all: {', '.join(f'{v:.3f}' for v in step_ms)}), "
          f"{1e3 * TRAIN_BATCH / median:.2f} images/s, max_memory_allocated {peak} bytes")
    for i, m in enumerate(metrics):
        print(f"train: step {WARMUP_STEPS + i}: loss {m['loss'].item():.6f} silog "
              f"{m['silog'].item():.6f} chamfer {m['chamfer'].item():.6f} launches "
              f"{per_step[i]}")
        check(all(np.isfinite(v.item()) for v in m.values()), f"step {i}: metric not finite")
        check(per_step[i] == STEP_LAUNCHES,
              f"step {i}: launches {per_step[i]}, expected {STEP_LAUNCHES}")
    changed = sum(not torch.equal(p.detach(), before[k]) for k, p in model.named_parameters())
    print(f"train: {changed} of {len(before)} parameter tensors changed; step count "
          f"{state.step}")
    check(changed == len(before), "some parameters did not change")

    share = train_kernel_share(step, state, batch, profile_dir)
    print(f"train: profile over 2 steps: {share}")
    del state, model, before
    return launches


def train_kernel_share(step, state, batch, profile_dir):
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
        (out / "chip_smoke_profile_train.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40, max_name_column_width=90))
    if total == 0:
        return "no device time in the profile: kernel share not measured"
    return (f"device time (sum of device events) {total / 2e3:.3f} ms per step; "
            + ", ".join(f"{k} {v / 2e3:.3f} ms ({100 * v / total:.1f}%)"
                        for k, v in ours.items())
            + f"; the port's kernels {100 * sum(ours.values()) / total:.1f}%; wall "
            f"{wall_us / 2e3:.3f} ms per step (profiled), device busy "
            f"{100 * busy_us / wall_us:.1f}%, {n_events} device events")


def step_against_plain(state_dict, gen, dtype):
    """Phase 6: one step at batch 2 through the kernels and through the
    unfused head and the plain chamfer, on the same weights and batch, in
    float32 or under bf16 autocast; returns the kernel run's launches."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import make_loss_fn

    image = torch.randn((2, 3, *TRAIN_HW), generator=gen).cuda()
    depth = (0.05 + 9.9 * torch.rand((2, 1, *TRAIN_HW), generator=gen)).cuda()
    label = "float32" if dtype == torch.float32 else "bf16 autocast"
    tol = STEP_TOL[dtype]
    results = {}
    for kernels in (True, False):
        args = flagship_args(compute_dtype="float32" if dtype == torch.float32 else "bfloat16",
                             use_fused_head=kernels, use_pallas_chamfer=kernels)
        model = build_model(args).cuda().train()
        model.load_state_dict(state_dict, strict=True)
        loss_fn = make_loss_fn(args)
        generator = torch.Generator(device="cuda").manual_seed(SEED)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, l_dense, l_chamfer = loss_fn(model, {"image": image, "depth": depth}, generator)
        loss.backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                 if k.startswith(("conv_out.", "adaptive_bins_layer.regressor."))}
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
    worst = max((max_rel(kern[3][k], plain[3][k]), k) for k in plain[3])
    print(f"step check {label}: loss, silog, chamfer within rtol {tol}; largest gradient "
          f"error {worst[0]:.3e} of the largest value ({worst[1]}; tolerance {tol})")
    check(worst[0] <= tol, f"step check {label} gradient {worst}")
    return kern[4]


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile requests under four cuDNN settings and the "
                             "training step, and write the tables to DIR")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    from mde_tpu_torch.kernels import bins_head, build, chamfer
    from mde_tpu_torch.models import UnetAdaptiveBins

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)

    toolchain(build)
    build_all(build, {bins_head._SOURCE: bins_head.library,
                      bins_head._TC_SOURCE: bins_head.tc_library,
                      chamfer._SOURCE: chamfer.library})

    serving_fwd = check_head_forward(bins_head, gen, 2, (FRAME_HW[0] // 2, FRAME_HW[1] // 2),
                                     "serving")[torch.float32]
    fwd = check_head_forward(bins_head, gen, TRAIN_BATCH, (TRAIN_HW[0] // 2, TRAIN_HW[1] // 2),
                             "training")
    bwd = check_head_backward(bins_head, gen)
    check_chunked_head(bins_head, gen)
    torch.cuda.empty_cache()
    cham = check_chamfer(chamfer, gen)
    cublas_yardstick(gen)
    torch.cuda.empty_cache()

    # each path is driven with the counts at 0 and read right after it
    launches = {"bins_head_fwd": serve(bins_head, gen, args.profile)}
    torch.cuda.empty_cache()

    shell = UnetAdaptiveBins(n_bins=N_BINS, min_val=1e-3, max_val=10.0,
                             encoder_name="efficientnet-b1")
    state_dict = seeded_state_dict(shell, gen)
    trained = train(state_dict, gen, args.profile)
    launches.update({k: trained[k] for k in ("bins_head_tc_fwd", "bins_head_tc_bwd",
                                             "chamfer")})
    torch.cuda.empty_cache()
    launches["bins_head_bwd"] = step_against_plain(state_dict, gen,
                                                   torch.float32)["bins_head_bwd"]
    torch.cuda.empty_cache()
    step_against_plain(state_dict, gen, torch.bfloat16)

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
