"""The yardstick's arithmetic: the H100's published peaks, the least time of
the port's kernels from their inputs' shapes, and the model's operations
counted on the plain reference's shapes.

Peaks (NVIDIA's H100 SXM data sheet, dense): 989 TFLOP/s bf16 and 495
TF32 on the tensor cores, 67 TFLOP/s float32 on the CUDA cores (an FMA
counts two: 33.5 T instructions a second), 3.35 TB/s of HBM.

A kernel's least time is the larger of its work over the rate and its bytes
over the HBM rate, each input byte read once and each output written once:
  * bins head forward: 2 x pixels x 128 x bins operations; the features and
    the float32 depth out;
  * bins head backward (pixel and weight kernels): 3 x that; the features
    read and their gradient written, and the upstream depth gradient;
  * chamfer reductions: 6 float32 instructions per (bin, valid pixel) pair
    (a subtract and a multiply for the distance, about four compares and
    selects for the two minima); the depths read and the per-pixel minima
    written, and the centres.
"""

import torch

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
F32_OPS = F32_FLOPS / 2
HBM_BYTES_PER_S = 3.35e12
HEAD_CHANNELS = 128


def least_s(work, rate, nbytes):
    return max(work / rate, nbytes / HBM_BYTES_PER_S)


def head_fwd_s(pixels, bins, bf16):
    item = 2 if bf16 else 4
    return least_s(2 * pixels * HEAD_CHANNELS * bins, BF16_FLOPS if bf16 else F32_FLOPS,
                   pixels * HEAD_CHANNELS * item + pixels * 4)


def head_bwd_s(pixels, bins, bf16):
    item = 2 if bf16 else 4
    return least_s(3 * 2 * pixels * HEAD_CHANNELS * bins, BF16_FLOPS if bf16 else F32_FLOPS,
                   2 * pixels * HEAD_CHANNELS * item + pixels * 4)


def chamfer_s(bins, valid_pixels, pixels, images):
    return least_s(6 * bins * valid_pixels, F32_OPS, 2 * pixels * 4 + images * bins * 4)


def model_flops(model, image_shape, cue_shapes=None):
    """Forward operations of the plain reference `model` (built on the meta
    device) on an input of `image_shape`, as torch's flop counter counts
    convolutions and matrix products."""
    from torch.utils.flop_counter import FlopCounterMode
    image = torch.empty(image_shape, device="meta")
    cues = None if cue_shapes is None else {
        k: torch.empty(s, device="meta") for k, s in cue_shapes.items()}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(image, cues)
    return counter.get_total_flops()


def train_flops(model, image_shape, cue_shapes=None):
    """Operations of a training step: the forward, then each convolution's
    and product's two gradients, its weight's and its input's, each as many
    as its forward, but the image's, which nothing needs where no cue joins
    it (the stem's input gradient). torch's counter is not used for the
    backward: it counts a grouped convolution's weight gradient as a dense
    convolution's."""
    total = 3 * model_flops(model, image_shape, cue_shapes)
    if cue_shapes is None:
        n, _, h, w = image_shape
        cout, cin, k, _ = model.encoder.original_model.conv_stem.weight.shape
        total -= 2 * n * cout * cin * k * k * -(-h // 2) * -(-w // 2)
    return total
