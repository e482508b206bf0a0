"""Swin-B backbone, the port of `mde_tpu/offline/swin.py` (:28-222): the
instance-cue detector's trunk.

Names follow mmdet's `backbone.*` (Swin-Transformer-Object-Detection,
mmdet/models/backbones/swin_transformer.py): `patch_embed.{proj,norm}`,
`layers.{s}.blocks.{b}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}`,
`layers.{s}.downsample.{reduction, norm}` and `norm{0..3}`, the keys
`mde_tpu/offline/swin_convert.py:94-133` reads. The relative-position index
is not a buffer here (mmdet keeps one; `load_detector` checks it against
this one).

Tokens stay (N, H, W, C) inside; the four outputs are NCHW. Casts follow the
JAX module: LayerNorms in float32 with flax's eps 1e-6 (mmdet: 1e-5), cast
back; the attention softmax in float32, cast back; the position bias and
the shift mask (0 / -100) added in the compute dtype; GELU exact. Each
block pads to whole windows after its first norm, as mmdet.
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from .layers import LayerNorm, compute_dtype


def window_partition(x, ws: int):
    """(N, H, W, C) -> (N*nH*nW, ws, ws, C); H, W divisible by ws."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    """(N*nH*nW, ws, ws, C) -> (N, H, W, C)."""
    c = windows.shape[-1]
    n = windows.shape[0] // (h // ws * w // ws)
    x = windows.reshape(n, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2*ws-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _index_on(ws: int, device: str) -> torch.Tensor:
    """The flat relative-position index of window `ws`, on `device`, once;
    a normal tensor even when first asked for under inference mode, so a
    later training step can save it for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(relative_position_index(ws).reshape(-1)).to(device)


def shift_attention_mask(hp: int, wp: int, ws: int, shift: int, device) -> torch.Tensor:
    """(num_windows, ws*ws, ws*ws) additive mask (0 / -100) for SW-MSA,
    built on `device`."""
    img = torch.zeros(hp, wp, device=device)
    cnt = 0
    for h_sl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w_sl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h_sl, w_sl] = cnt
            cnt += 1
    mw = img.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x, mask=None):
        """x (B, T, C), T = ws*ws; mask (nW, T, T) or None; B = N * nW."""
        b, t, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(b, t, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0)
        logits = (q @ k.transpose(-2, -1)) * hd ** -0.5
        table = self.relative_position_bias_table
        bias = table[_index_on(self.window_size, str(table.device))].reshape(t, t, h)
        bias = bias.permute(2, 0, 1)
        logits = logits + bias[None].to(logits.dtype)
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(b // nw, nw, h, t, t)
                      + mask[None, :, None].to(logits.dtype)).reshape(b, h, t, t)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, t, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size=7, shift=0, mlp_ratio=4.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, mask):
        """x (N, H, W, C); mask: the stage's shift mask (used when shifted)."""
        n, h, w, c = x.shape
        ws = self.window_size
        y = self.norm1(x)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
        attn = self.attn(window_partition(y, ws).reshape(-1, ws * ws, c),
                         mask if self.shift else None)
        y = window_reverse(attn.reshape(-1, ws, ws, c), ws, hp, wp)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        if pad_b or pad_r:
            y = y[:, :h, :w]
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 concat + LN + linear 4C -> 2C."""

    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(y))


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch=4):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        """(N, 3, H, W), H and W multiples of the patch -> (N, H/4, W/4, dim)."""
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if b % 2 == 0 else window_size // 2)
            for b in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    """Swin trunk -> 4 NCHW feature maps at strides 4/8/16/32 (Swin-B:
    embed 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32), window 7)."""

    def __init__(self, embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                 window_size=7, use_checkpoint=False):
        super().__init__()
        self.window_size = window_size
        # recompute each block in the backward (JAX: nn.remat of each block,
        # mde_tpu/offline/swin.py:184-190); Swin holds no BatchNorm stats
        self.use_checkpoint = use_checkpoint
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** s, depth, num_heads[s], window_size,
                       s < len(depths) - 1) for s, depth in enumerate(depths))
        for s in range(len(depths)):
            self.add_module(f"norm{s}", LayerNorm(embed_dim * 2 ** s))

    @property
    def dtype(self):
        return compute_dtype(self.patch_embed.proj)

    def forward(self, x):
        h_in, w_in = x.shape[-2:]
        x = F.pad(x.to(self.dtype), (0, (4 - w_in % 4) % 4, 0, (4 - h_in % 4) % 4))
        y = self.patch_embed(x)
        ws = self.window_size
        outs = []
        for s, layer in enumerate(self.layers):
            h, w = y.shape[1:3]
            hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
            mask = (shift_attention_mask(hp, wp, ws, ws // 2, y.device)
                    if len(layer.blocks) > 1 else None)
            for block in layer.blocks:
                if self.use_checkpoint and torch.is_grad_enabled():
                    y = checkpoint(block, y, mask, use_reentrant=False)
                else:
                    y = block(y, mask)
            outs.append(getattr(self, f"norm{s}")(y).permute(0, 3, 1, 2).contiguous())
            if layer.downsample is not None:
                y = layer.downsample(y)
        return outs


def resize_rel_pos_table(table: np.ndarray, target_len: int) -> np.ndarray:
    """Bicubic resize of an (L1, nH) relative-position-bias table to (L2, nH)
    when window sizes differ, the port of `mde_tpu/offline/swin_convert.py:53-92`
    (the fork's checkpoint loader, mmcv_custom/checkpoint.py:336-353:
    F.interpolate(mode='bicubic', align_corners=False) of the (S1, S1) grid),
    as a separable float64 product in numpy."""
    l1, nh = table.shape
    s1, s2 = int(round(l1 ** 0.5)), int(round(target_len ** 0.5))
    if s1 * s1 != l1 or s2 * s2 != target_len:
        raise ValueError(f"not square tables: {l1} -> {target_len}")
    w = _bicubic_matrix(s1, s2)
    grid = table.astype(np.float64).reshape(s1, s1, nh)
    out = np.einsum("ab,bch->ach", w, grid)
    out = np.einsum("cd,adh->ach", w, out)
    return out.reshape(target_len, nh).astype(table.dtype)


def _torch_cubic(d, a=-0.75):
    """torch's cubic convolution weight at distance d (0 <= d < 2)."""
    d = abs(float(d))
    if d <= 1.0:
        return (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0
    return a * (d ** 3 - 5.0 * d ** 2 + 8.0 * d - 4.0)


def _bicubic_matrix(s_in: int, s_out: int) -> np.ndarray:
    """(s_out, s_in) matrix of torch's bicubic resize along one axis:
    half-pixel source coordinates, 4 taps, border taps clamped into range."""
    w = np.zeros((s_out, s_in), np.float64)
    scale = s_in / s_out
    for i in range(s_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        for k, wk in zip(range(x0 - 1, x0 + 3),
                         (_torch_cubic(1 + t), _torch_cubic(t), _torch_cubic(1 - t),
                          _torch_cubic(2 - t))):
            w[i, min(max(k, 0), s_in - 1)] += wk
    return w
