"""Plain PyTorch reference of AdaBins with the paper's cues, for the
benchmark's comparisons: EfficientNet-B1 encoder, UNet decoder, mViT bins
head, plain head (1x1 conv, softmax over bins, sum with the centres), the
cue embedders and CueMLPs of the input insertion point, SILog + w x the
bins-chamfer loss, the global-norm clip and AdamW under OneCycle.

Written from the AdaBins paper (arXiv 2011.14141), the reference repository's
models/ and loss.py, and the published parameter files. It imports nothing of
the program under test: only torch and numpy. Parameter names follow the
reference repository's state_dicts, so one seeded weight dict loads into the
program and into this model alike.

Numerics follow the published code where it chooses: TF-'SAME' padding on the
encoder's strided convs; batch statistics in training mode; a 1x1 decoder conv
declared with padding 1; align-corners bilinear resizes (computed here in
float64, or float32 for bf16 maps); post-norm transformer layers with
LayerNorm eps 1e-6 (the JAX package's, which the program keeps); bins
widths normalised by ReLU + 0.1. Under bf16 autocast, the precision a
configuration states, the attention softmax and the bins regressor's output
are float32, rounded back to the input's dtype where the published code
keeps it, and the head rounds as the published bf16 head does.
Dropout masks of the mViT are drawn as the configuration seeds them: one
generator per step, seeded from (seed, step, 0), drawing the four masks of
each layer in order.

`Quant.fn` lowers the precision of every conv and linear operand (inputs and
weights) for the control: `fp8` rounds each to float8 e4m3 with a per-tensor
scale, then computes in float32.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_B0_STAGES = ((1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2), (6, 3, 2, 80, 3),
              (6, 5, 1, 112, 3), (6, 5, 2, 192, 4), (6, 3, 1, 320, 1))
_WIDTH, _DEPTH = 1.0, 1.1  # efficientnet-b1
_FP8_MAX = 448.0


def fp8(t):
    """t rounded to float8 e4m3 under a per-tensor scale, back in t's dtype;
    the gradient passes through the rounding unchanged."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / _FP8_MAX
    rounded = ((t.detach() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (rounded - t).detach()


class Quant:
    """The precision of the conv and linear operands: None is exact."""
    fn = None


def _q(t):
    return t if Quant.fn is None else Quant.fn(t)


def conv(x, w, b=None, stride=1, padding=0, groups=1):
    return F.conv2d(_q(x), _q(w), b, stride, padding, 1, groups)


def linear(x, w, b=None):
    return F.linear(_q(x), _q(w), b)


def round_channels(c, divisor=8):
    c *= _WIDTH
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * c else new)


class Conv(nn.Module):
    """Weight (and bias) of a conv, named as torch's Conv2d names them."""

    def __init__(self, cin, cout, k, bias=True, groups=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.groups = groups

    def forward(self, x, stride=1, padding=0):
        return conv(x, self.weight, self.bias, stride, padding, self.groups)


class SameConv(Conv):
    """TF-'SAME' padding: the extra row and column on the bottom and right."""

    def forward(self, x, stride=1):
        k = self.weight.shape[-1]
        pads = []
        for i in x.shape[-2:]:
            total = max((-(i // -stride) - 1) * stride + k - i, 0)
            pads.append((total // 2, total - total // 2))
        (t, b), (l, r) = pads
        return conv(F.pad(x, (l, r, t, b)), self.weight, self.bias, stride, 0, self.groups)


class BN(nn.Module):
    """BatchNorm: batch statistics in training mode (the running statistics
    are not tracked here), running statistics in eval mode; statistics in
    float32 whatever the input's dtype, the output in the input's."""

    def __init__(self, c, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.eps = eps

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class SE(nn.Module):
    def __init__(self, c, reduced):
        super().__init__()
        self.conv_reduce = Conv(c, reduced, 1)
        self.conv_expand = Conv(reduced, c, 1)

    def forward(self, x):
        g = self.conv_expand(F.silu(self.conv_reduce(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(g)


class Block(nn.Module):
    """MBConv (expand > 1) or the stage-0 depthwise-separable block."""

    def __init__(self, cin, cout, k, stride, expand):
        super().__init__()
        mid = cin * expand
        self.expand, self.stride = expand, stride
        if expand > 1:
            self.conv_pw = Conv(cin, mid, 1, bias=False)
            self.bn1 = BN(mid, 1e-3)
            self.conv_dw = SameConv(mid, mid, k, bias=False, groups=mid)
            self.bn2 = BN(mid, 1e-3)
            self.se = SE(mid, max(1, int(cin * 0.25)))
            self.conv_pwl = Conv(mid, cout, 1, bias=False)
            self.bn3 = BN(cout, 1e-3)
        else:
            self.conv_dw = SameConv(cin, cin, k, bias=False, groups=cin)
            self.bn1 = BN(cin, 1e-3)
            self.se = SE(cin, max(1, int(cin * 0.25)))
            self.conv_pw = Conv(cin, cout, 1, bias=False)
            self.bn2 = BN(cout, 1e-3)
        self.skip = stride == 1 and cin == cout

    def forward(self, x):
        if self.expand > 1:
            y = F.silu(self.bn1(self.conv_pw(x)))
            y = F.silu(self.bn2(self.conv_dw(y, self.stride)))
            y = self.bn3(self.conv_pwl(self.se(y)))
        else:
            y = F.silu(self.bn1(self.conv_dw(x, self.stride)))
            y = self.bn2(self.conv_pw(self.se(y)))
        return y + x if self.skip else y


class EfficientNet(nn.Module):
    """tf_efficientnet_b1_ap's trunk; returns the stage outputs the decoder
    reads (stages 0, 1, 2, 4) and conv_head's output before its BN."""

    def __init__(self, in_chs):
        super().__init__()
        stem = round_channels(32)
        self.conv_stem = SameConv(in_chs, stem, 3, bias=False)
        self.bn1 = BN(stem, 1e-3)
        stages, c = [], stem
        for expand, k, stride, base_c, base_r in _B0_STAGES:
            out = round_channels(base_c)
            reps = int(math.ceil(base_r * _DEPTH))
            stages.append(nn.Sequential(*[Block(c if r == 0 else out, out, k,
                                                stride if r == 0 else 1, expand)
                                          for r in range(reps)]))
            c = out
        self.blocks = nn.Sequential(*stages)
        self.conv_head = Conv(c, round_channels(1280), 1, bias=False)
        self.bn2 = BN(round_channels(1280), 1e-3)  # feeds no output the decoder reads

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_stem(x, 2)))
        skips = []
        for stage in self.blocks:
            for block in stage:
                y = block(y)
            skips.append(y)
        return skips[0], skips[1], skips[2], skips[4], self.conv_head(y)


class Encoder(nn.Module):
    def __init__(self, in_chs):
        super().__init__()
        self.original_model = EfficientNet(in_chs)


def resize(x, hw):
    """Bilinear, align corners, computed in float64 for a float32 input and
    in float32 for a bf16 one, rounded back to the input's dtype."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    work = torch.float32 if x.dtype == torch.bfloat16 else torch.float64
    return F.interpolate(x.to(work), size=tuple(hw), mode="bilinear",
                         align_corners=True).to(x.dtype)


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self._net = nn.ModuleDict({"0": Conv(cin, cout, 3), "1": BN(cout, 1e-5),
                                   "3": Conv(cout, cout, 3), "4": BN(cout, 1e-5)})

    def forward(self, x, skip):
        n = self._net
        y = torch.cat([resize(x, skip.shape[-2:]), skip], 1)
        y = F.leaky_relu(n["1"](n["0"](y, padding=1)), 0.01)
        return F.leaky_relu(n["4"](n["3"](y, padding=1)), 0.01)


class Decoder(nn.Module):
    def __init__(self, f=1280, skips=(16, 24, 40, 112)):
        super().__init__()
        self.conv2 = Conv(f, f, 1)
        self.up1 = Up(f + skips[3], f // 2)
        self.up2 = Up(f // 2 + skips[2], f // 4)
        self.up3 = Up(f // 4 + skips[1], f // 8)
        self.up4 = Up(f // 8 + skips[0], f // 16)
        self.conv3 = Conv(f // 16, 128, 3)

    def forward(self, s0, s1, s2, s4, head):
        y = self.conv2(head, padding=1)  # 1x1 with padding 1, as published
        y = self.up1(y, s4)
        y = self.up2(y, s2)
        y = self.up3(y, s1)
        return self.conv3(self.up4(y, s0), padding=1)


def dropout(x, generator, training, rate=0.1):
    if not training:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-6)


class Attention(nn.Module):
    def __init__(self, e=128, heads=4):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * e))
        self.out_proj = Linear(e, e)
        self.heads = heads

    def forward(self, x, generator):
        n, s, e = x.shape
        h, hd = self.heads, e // self.heads
        q, k, v = linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)
        q, k, v = (t.reshape(n, s, h, hd).transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(_q(q), _q(k).transpose(-2, -1)) / math.sqrt(hd)
        w = torch.softmax(logits.float(), -1).to(logits.dtype)
        w = dropout(w, generator, self.training)
        out = torch.matmul(_q(w), _q(v)).transpose(1, 2).reshape(n, s, e)
        return self.out_proj(out)


class Layer(nn.Module):
    def __init__(self, e=128, ff=1024):
        super().__init__()
        self.self_attn = Attention(e)
        self.linear1, self.linear2 = Linear(e, ff), Linear(ff, e)
        self.norm1, self.norm2 = LayerNorm(e), LayerNorm(e)

    def forward(self, x, g):
        x = self.norm1(x + dropout(self.self_attn(x, g), g, self.training))
        y = self.linear2(dropout(F.relu(self.linear1(x)), g, self.training))
        return self.norm2(x + dropout(y, g, self.training))


class Layers(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList(Layer() for _ in range(4))


class PatchTransformer(nn.Module):
    def __init__(self, cin, e=128):
        super().__init__()
        self.embedding_convPxP = Conv(cin, e, 16)
        self.positional_encodings = nn.Parameter(torch.empty(500, e))
        self.transformer_encoder = Layers()

    def forward(self, x, g):
        y = self.embedding_convPxP(x, stride=16).flatten(2).transpose(1, 2)
        y = y + self.positional_encodings[:y.shape[1]].to(y.dtype)
        for layer in self.transformer_encoder.layers:
            y = layer(y, g)
        return y


class MViT(nn.Module):
    def __init__(self, cin, n_bins):
        super().__init__()
        self.patch_transformer = PatchTransformer(cin)
        self.conv3x3 = Conv(cin, 128, 3)
        self.regressor = nn.ModuleDict({"0": Linear(128, 256), "2": Linear(256, 256),
                                        "4": Linear(256, n_bins)})

    def forward(self, x, g):
        tgt = self.patch_transformer(x, g)
        proj = self.conv3x3(x, padding=1)
        n, c, h, w = proj.shape
        maps = torch.bmm(_q(tgt[:, 1:129]), _q(proj.reshape(n, c, h * w))).reshape(n, -1, h, w)
        r = self.regressor
        y = F.leaky_relu(r["0"](tgt[:, 0]), 0.01)
        y = r["4"](F.leaky_relu(r["2"](y), 0.01)).float()
        y = F.relu(y) + 0.1
        return y / y.sum(1, keepdim=True), maps


class AdaBins(nn.Module):
    """UnetAdaptiveBins with cues at the input (glove-25d semantics,
    ade20k_swin[_human_sizes] instances) or none; returns (bin_edges, pred
    at half the input's size)."""

    def __init__(self, n_bins=256, min_depth=1e-3, max_depth=10.0, semantics=None,
                 instances=None):
        super().__init__()
        self.n_bins, self.min_depth, self.max_depth = n_bins, min_depth, max_depth
        self.semantics, self.instances = semantics, instances
        n_cues = (25 if semantics else 0) + (35 if instances else 0) + (
            10 if instances and "human_sizes" in instances else 0)
        if instances:
            self.instance_areas_fc = nn.ModuleDict({"0": Conv(1, 10, 1), "2": Conv(10, 10, 1)})
            if "human_sizes" in instances:
                self.instance_absolute_sizes_fc = nn.ModuleDict(
                    {"0": Conv(3, 10, 1), "2": Conv(10, 10, 1)})
        self.encoder = Encoder(3 + n_cues)
        self.decoder = Decoder()
        self.adaptive_bins_layer = MViT(128, n_bins)
        self.conv_out = nn.ModuleDict({"0": Conv(128, n_bins, 1)})

    @staticmethod
    def _mlp(m, x):
        return F.relu(m["2"](F.relu(m["0"](x))))

    def forward(self, image, cues=None, generator=None):
        x = image
        if cues is not None:
            parts = [image]
            if self.semantics:
                parts.append(cues["semantics"])
            if self.instances:
                areas = cues["instance_areas"]
                parts += [cues["instance_labels"],
                          self._mlp(self.instance_areas_fc,
                                    areas[:, :1] / (image.shape[-2] * image.shape[-1]))]
                if "human_sizes" in self.instances:
                    parts.append(self._mlp(self.instance_absolute_sizes_fc, areas[:, 1:4]))
            x = torch.cat(parts, 1)
        unet = self.decoder(*self.encoder.original_model(x))
        widths, maps = self.adaptive_bins_layer(unet, generator)
        edges = torch.cumsum(F.pad((self.max_depth - self.min_depth) * widths, (1, 0),
                                   value=self.min_depth), 1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        head = self.conv_out["0"]
        if maps.dtype == torch.bfloat16:
            with torch.autocast(maps.device.type, enabled=False):
                return edges, Bf16Head.apply(_q(maps), _q(head.weight), head.bias, centers)
        probs = torch.softmax(head(maps).float(), 1)
        return edges, (probs * centers[:, :, None, None]).sum(1, keepdim=True)


class Bf16Head(torch.autograd.Function):
    """The published bf16 bins head (the JAX package's fused kernel), its
    rounding points and gradient rule: logits summed in float32 from bf16
    features and weights, rounded to bf16, the bf16 bias added in bf16, the
    softmax and the sum with the centres in float32; backward dlog = p (c -
    depth) g in float32, rounded to bf16 for the two products, which sum in
    float32; the features' gradient rounded to bf16; the weights', bias's
    and centres' in float32."""

    @staticmethod
    def forward(ctx, x, weight, bias, centers):
        w = weight.reshape(weight.shape[0], -1).to(torch.bfloat16).float()
        logits = torch.einsum("bchw,nc->bnhw", x.float(), w).to(torch.bfloat16)
        probs = torch.softmax((logits + bias.to(torch.bfloat16)[:, None, None]).float(), 1)
        depth = (probs * centers.float()[:, :, None, None]).sum(1, keepdim=True)
        ctx.save_for_backward(x, weight, centers, probs, depth)
        return depth

    @staticmethod
    def backward(ctx, grad):
        x, weight, centers, probs, depth = ctx.saved_tensors
        pg = probs * grad.float()
        dlog = pg * (centers.float()[:, :, None, None] - depth)
        rounded = dlog.to(torch.bfloat16).float()
        w = weight.reshape(weight.shape[0], -1).to(torch.bfloat16).float()
        dx = torch.einsum("bnhw,nc->bchw", rounded, w).to(x.dtype)
        dw = torch.einsum("bnhw,bchw->nc", rounded, x.float()).reshape(weight.shape)
        return dx, dw, dlog.sum((0, 2, 3)), pg.sum((2, 3))


def take_rows(table, labels):
    """table (n, C) gathered by labels (N, H, W) in [0, n) -> (N, C, H, W)."""
    return table[labels.long()].permute(0, 3, 1, 2)


def embed_cues(raw, tables, instances):
    """The cue channels from the raw maps of a batch: glove-25d semantic
    embeddings; instance label embeddings (labels outside the table go to
    the background class 100), areas and, for human_sizes, the class's
    three sizes."""
    sem = take_rows(tables["semantics"], raw["semantics"][:, 0])
    labels = raw["instance_labels"][:, 0].long()
    n_rows = tables["instances"].shape[0]
    labels = torch.where((labels < 0) | (labels > n_rows - 1), 100, labels)
    areas = raw["instance_areas"].float()
    if "human_sizes" in instances:
        areas = torch.cat([areas, take_rows(tables["human_sizes"], labels)], 1)
    return {"semantics": sem, "instance_labels": take_rows(tables["instances"], labels),
            "instance_areas": areas}


def silog(pred, depth, min_depth):
    """10 sqrt(Var_unbiased(g) + 0.15 mean(g)^2), g = log pred - log depth
    over the pixels with depth > min_depth, pred resized to depth's size."""
    pred = resize(pred, depth.shape[-2:])
    mask = depth > min_depth
    g = torch.log(pred[mask]) - torch.log(depth[mask])
    return 10.0 * torch.sqrt(g.var() + 0.15 * g.mean() ** 2)


def chamfer(edges, depth, threshold=1e-3, chunk=8192):
    """Mean over images of the mean over bins of the squared distance to
    the nearest valid depth, plus the same mean over valid depths of the
    distance to the nearest bin centre."""
    centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
    total = 0.0
    for i in range(centers.shape[0]):
        d = depth[i].reshape(-1)
        d = d[d >= threshold]
        if d.numel() == 0:
            continue
        c = centers[i]
        near_bin, sum_y = None, 0.0
        for s in range(0, d.numel(), chunk):
            d2 = (d[s:s + chunk, None] - c[None, :]) ** 2
            sum_y = sum_y + d2.amin(1).sum()
            m = d2.amin(0)
            near_bin = m if near_bin is None else torch.minimum(near_bin, m)
        total = total + near_bin.mean() + sum_y / d.numel()
    return total / centers.shape[0]


def dropout_seed(seed, step):
    """The configuration's seed for step `step`'s dropout masks."""
    return int(np.random.SeedSequence([seed, step, 0]).generate_state(1)[0])


def onecycle(step, total, max_lr, div, final_div, pct=0.3):
    """OneCycleLR (cos) lr and the opposite beta1 cycle 0.95 -> 0.85 -> 0.95."""
    def cos(a, b, t):
        return b + (a - b) / 2.0 * (math.cos(math.pi * t) + 1.0)
    up = pct * total - 1.0
    down = total - 1.0 - up
    if step <= up:
        t = min(max(step / max(up, 1.0), 0.0), 1.0)
        return cos(max_lr / div, max_lr, t), cos(0.95, 0.85, t)
    t = min(max((step - up) / max(down, 1.0), 0.0), 1.0)
    return cos(max_lr, max_lr / div / final_div, t), cos(0.85, 0.95, t)


class AdamW:
    """AdamW (beta2 0.999, eps 1e-8, decoupled decay) after a clip of the
    gradients to global norm `clip`, lr and beta1 given per update."""

    def __init__(self, params, wd, clip=0.1):
        self.params = list(params)
        self.wd, self.clip = wd, clip
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    def clip_grads(self):
        """Clip in place; returns the clipped gradients."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = torch.clamp(self.clip / (norm + 1e-6), max=1.0).float()
        return [g * scale for g in grads]

    @torch.no_grad()
    def step(self, grads, lr, beta1):
        self.t += 1
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - lr * self.wd)
            m.mul_(beta1).add_(g, alpha=1.0 - beta1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (v / (1.0 - 0.999 ** self.t)).sqrt_().add_(1e-8)
            p.addcdiv_(m, denom, value=-lr / (1.0 - beta1 ** self.t))
