"""miniViT adaptive-bins head, port of `mde_tpu/models/mvit.py`
(reference models/miniViT.py, models/layers.py), NCHW maps, batch-first tokens.

A 16x16 stride-16 patch conv (VALID: the remainder is dropped) and a learned
500-entry positional table feed 4 post-norm transformer layers (d_model 128,
4 heads, FFN 1024, ReLU, dropout 0.1 at the four points of
`mde_tpu/models/mvit.py:46, 66, 71, 73`). Attention is written out as matmuls
and a softmax; the parameter names are those of torch's
nn.TransformerEncoderLayer (packed q|k|v `in_proj_weight`), so the
reference's state_dicts load as they are. LayerNorm eps is flax's 1e-6, as in
the JAX package (torch's default, and the reference's, is 1e-5).

Token 0 regresses normalized bin widths through a 128->256->256->n_bins MLP;
tokens 1..128 are queries dotted against a 3x3-conv projection of the decoder
map, giving 128 range-attention maps. That slice needs at least 129 tokens.

In training mode the dropout masks are drawn from the `generator` passed to
`forward` (the train step seeds one per step, as the JAX step folds its rng
per step); without one, from torch's global generator. The two frameworks'
masks differ for the same seed.

Tensor parallelism (`models/tp.py` sets `tp`, the rank's `parallel.Grid`):
an attention module whose `in_proj` holds the q, k and v rows of this
rank's H/m heads runs those heads and closes `out_proj` (its input columns
of those heads) with a sum over the model group, the bias added once after
it; a layer whose `linear1` holds rows of the FFN runs its slice and closes
`linear2` likewise. Dropout on a split tensor (the local heads' attention
weights, the FFN slice) draws the whole tensor's mask and keeps its slice,
so the ranks' generators stay in step with one process's.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import copy_to_model, reduce_from_model

_LN_EPS = 1e-6  # flax nn.LayerNorm default, as in mde_tpu/models/mvit.py:67,74


def dropout(x, rate: float, training: bool, generator=None, shard=None):
    """flax nn.Dropout: keep each value with probability 1 - rate and scale
    the kept ones by 1 / (1 - rate); the mask comes from `generator`. With
    `shard=(dim, parts, index)` x is slice `index` of `parts` along `dim` of
    a larger tensor: the larger tensor's mask is drawn, and x's slice of it
    kept."""
    if not training or rate == 0.0:
        return x
    shape = list(x.shape)
    if shard is not None:
        dim, parts, index = shard
        shape[dim] *= parts
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    if shard is not None:
        keep = keep.narrow(dim, index * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _row_parallel(x, linear):
    """`linear` on this rank's input columns, summed over the model group
    (in at least float32, one rounding to x's dtype after the bias, as one
    product rounds once), then its bias."""
    partial = F.linear(x, linear.weight)
    wide = torch.promote_types(partial.dtype, torch.float32)
    return (reduce_from_model(partial.to(wide)) + linear.bias).to(partial.dtype)


class MultiheadSelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (in_proj_weight/bias, out_proj),
    computed as explicit matmuls and a softmax."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.tp = None

    def forward(self, x, generator=None):
        # x: (N, S, E)
        n, s, e = x.shape
        h = self.num_heads
        hd = e // h
        shard = None
        if self.tp is not None:  # this rank's heads
            h //= self.tp.model
            shard = (1, self.tp.model, self.tp.model_index)
            x = copy_to_model(x)
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(n, s, h, hd).transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd)
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        weights = dropout(weights, self.dropout, self.training, generator, shard)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(n, s, h * hd)
        return self.out_proj(out) if self.tp is None else _row_parallel(out, self.out_proj)


class TransformerEncoderLayer(nn.Module):
    """Post-norm layer: x = LN(x + Drop(SA(x))); x = LN(x + Drop(FFN(x)))."""

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(embed_dim, num_heads, dropout)
        self.linear1 = nn.Linear(embed_dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim, eps=_LN_EPS)
        self.norm2 = nn.LayerNorm(embed_dim, eps=_LN_EPS)
        self.dropout = dropout
        self.tp = None

    def forward(self, x, generator=None):
        drop = lambda t, shard=None: dropout(t, self.dropout, self.training, generator, shard)
        x = self.norm1(x + drop(self.self_attn(x, generator)))
        if self.tp is None:
            y = self.linear2(drop(F.relu(self.linear1(x))))
        else:  # this rank's slice of the FFN
            shard = (-1, self.tp.model, self.tp.model_index)
            y = _row_parallel(drop(F.relu(self.linear1(copy_to_model(x))), shard), self.linear2)
        return self.norm2(x + drop(y))


class _Layers(nn.Module):
    """Holder giving the reference's `transformer_encoder.layers.{i}` names."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PatchTransformerEncoder(nn.Module):
    """Patch embed + positional table + 4 transformer layers
    (reference layers.py:5-24). Returns (N, S, E)."""

    def __init__(self, in_channels: int, patch_size: int = 16,
                 embedding_dim: int = 128, num_heads: int = 4,
                 num_layers: int = 4, max_tokens: int = 500):
        super().__init__()
        self.embedding_convPxP = nn.Conv2d(in_channels, embedding_dim,
                                           patch_size, patch_size, 0)
        self.positional_encodings = nn.Parameter(torch.rand(max_tokens, embedding_dim))
        self.transformer_encoder = _Layers(
            TransformerEncoderLayer(embedding_dim, num_heads, 1024)
            for _ in range(num_layers))

    def forward(self, x, generator=None):
        y = self.embedding_convPxP(x).flatten(2).transpose(1, 2)   # (N, S, E)
        y = y + self.positional_encodings[:y.shape[1]].to(y.dtype)
        for layer in self.transformer_encoder.layers:
            y = layer(y, generator)
        return y


def pixelwise_dot_product(x_nchw, queries_nqc):
    """(N, C, H, W) x (N, Q, C) -> (N, Q, H, W) range-attention maps
    (reference layers.py:27-36), one batched matmul; the result is
    channel-major, the layout the bins-head kernel reads."""
    n, c, h, w = x_nchw.shape
    return torch.bmm(queries_nqc, x_nchw.reshape(n, c, h * w)).reshape(n, -1, h, w)


class MViT(nn.Module):
    """Adaptive-bins head (reference miniViT.py:7-45)."""

    def __init__(self, in_channels: int, n_query_channels: int = 128,
                 patch_size: int = 16, dim_out: int = 256,
                 embedding_dim: int = 128, num_heads: int = 4, norm: str = "linear"):
        super().__init__()
        self.norm = norm
        self.n_query_channels = n_query_channels
        self.patch_transformer = PatchTransformerEncoder(
            in_channels, patch_size, embedding_dim, num_heads)
        self.conv3x3 = nn.Conv2d(in_channels, embedding_dim, 3, 1, 1)
        self.regressor = nn.Sequential(
            nn.Linear(embedding_dim, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, dim_out))

    def forward(self, x, generator=None):
        tgt = self.patch_transformer(x, generator)
        proj = self.conv3x3(x)
        regression_head = tgt[:, 0]
        queries = tgt[:, 1:self.n_query_channels + 1]
        range_attention_maps = pixelwise_dot_product(proj, queries)

        y = self.regressor(regression_head).float()
        if self.norm == "linear":
            y = F.relu(y) + 0.1
            y = y / y.sum(dim=1, keepdim=True)
        elif self.norm == "softmax":
            y = torch.softmax(y, dim=1)
        else:  # sigmoid
            y = torch.sigmoid(y)
            y = y / y.sum(dim=1, keepdim=True)
        return y, range_attention_maps
