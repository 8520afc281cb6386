"""MobileViTv2 (width 1.0) feature backbone, channels-last (counterpart of
``semstereo_tpu/nn/backbone.py``).

Module names follow the reference ``Feature`` wrapper around timm's
``mobilevitv2_100``: ``conv_stem`` and ``block0``..``block4`` (timm stages),
inside them timm's byobnet names (``conv1_1x1``/``conv2_kxk``/``conv3_1x1``,
``conv_kxk``/``conv_1x1``/``transformer.N``/``norm``/``conv_proj``).  The
1x1 convs of the transformer are channels-last matmuls on their Conv2d
weights.  GroupNorm(1) uses eps 1e-6, as flax's GroupNorm in the JAX package.

On row slabs (``layers.split_rows``): the 3x3 convs take their halos
(``layers.conv_cl``); GroupNorm's statistics span the image, so it takes
them over the space group in two passes (the per-image sum, then the
squared deviations from the global mean, over the slabs' equal counts),
each a differentiable all-reduce; the separable attention's softmax runs over all the image's
patches, with the global max (no gradient: the softmax does not depend on
it), the global sum of the exponentials and the global sum of the
score-weighted keys (differentiable).  Both compute in fp32 and round to
the input's dtype where one process's ``var_mean``, ``softmax`` and
``k * scores`` round, so that a bf16 split follows one process closely.  A MobileViTv2 block's slab must hold an even
number of rows, so that no slab but the last would pad
(``parallel.check_space_rows`` refuses the others).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semstereo_tpu_torch.nn.layers import BatchNorm, conv_cl, rows_of
from semstereo_tpu_torch.parallel import space_max, space_sum

GN_EPS = 1e-6


def _pointwise(conv: nn.Conv2d, x):
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class GroupNorm1(nn.Module):
    """GroupNorm with one group over all non-batch axes, affine on the last."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # One group spans millions of elements: a full-grid reduction for the
        # statistics, then one fused pass y = x * a + b with per-channel a, b
        # (layer_norm and group_norm reduce each group in a single block).
        dims = tuple(range(1, x.dim()))
        rows = rows_of(self)
        if rows is None:
            var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
        else:  # in fp32 over the equal slabs, rounded to x's dtype as var_mean's results are
            xf = x.float()
            n = xf[0].numel() * rows.space
            mean = (space_sum(xf.sum(dims), rows) / n).reshape(-1, *[1] * len(dims))
            var = (space_sum((xf - mean).square().sum(dims), rows) / n).reshape(mean.shape)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        a = torch.rsqrt(var.float() + GN_EPS) * self.weight.float()
        b = self.bias.float() - mean.float() * a
        return torch.addcmul(b.to(x.dtype), x, a.to(x.dtype))


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, groups=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(conv_cl(self.conv, x))
        return F.silu(x) if self.act else x


class BottleneckBlock(nn.Module):
    """MobileNetV2 inverted residual, expansion 2, SiLU."""

    def __init__(self, cin, cout, stride=1, expand=2):
        super().__init__()
        mid = cin * expand
        self.conv1_1x1 = ConvNormAct(cin, mid, 1)
        self.conv2_kxk = ConvNormAct(mid, mid, 3, stride=stride, groups=mid)
        self.conv3_1x1 = ConvNormAct(mid, cout, 1, act=False)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.conv3_1x1(self.conv2_kxk(self.conv1_1x1(x)))
        return x + y if self.residual else y


class LinearSelfAttention(nn.Module):
    """Separable self-attention on [B, P, N, C]: softmax context scores over
    the tokens N, one context vector, ReLU-gated values."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.qkv_proj = nn.Conv2d(dim, 1 + 2 * dim, 1)
        self.out_proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        qkv = _pointwise(self.qkv_proj, x)
        q, k, v = torch.split(qkv, [1, self.dim, self.dim], dim=-1)
        rows = rows_of(self)
        if rows is None:
            scores = torch.softmax(q, dim=2)
            context = torch.sum(k * scores, dim=2, keepdim=True)
        else:  # the softmax over every patch of the image, rounded where one process's is
            qf = q.float()
            e = torch.exp(qf - space_max(qf.amax(dim=2, keepdim=True), rows))
            scores = (e / space_sum(e.sum(2, keepdim=True), rows)).to(q.dtype)
            context = space_sum((k * scores).float().sum(2, keepdim=True), rows).to(k.dtype)
        return _pointwise(self.out_proj, torch.relu(v) * context)


class LinearTransformerBlock(nn.Module):
    def __init__(self, dim, ffn_mult=2):
        super().__init__()
        self.norm1 = GroupNorm1(dim)
        self.attn = LinearSelfAttention(dim)
        self.norm2 = GroupNorm1(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Conv2d(dim, ffn_mult * dim, 1)
        self.mlp.fc2 = nn.Conv2d(ffn_mult * dim, dim, 1)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        y = _pointwise(self.mlp.fc2, F.silu(_pointwise(self.mlp.fc1, self.norm2(x))))
        return x + y


class MobileVitV2Block(nn.Module):
    def __init__(self, cin, dim, depth, patch=(2, 2)):
        super().__init__()
        self.patch = patch
        self.conv_kxk = ConvNormAct(cin, cin, 3, groups=cin)
        self.conv_1x1 = nn.Conv2d(cin, dim, 1, bias=False)
        self.transformer = nn.Sequential(*[LinearTransformerBlock(dim) for _ in range(depth)])
        self.norm = GroupNorm1(dim)
        self.conv_proj = ConvNormAct(dim, cin, 1, act=False)

    def forward(self, x):
        b, h0, w0, _ = x.shape
        ph, pw = self.patch
        y = _pointwise(self.conv_1x1, self.conv_kxk(x))
        pad_b, pad_r = (-h0) % ph, (-w0) % pw
        if pad_b and rows_of(self) is not None:
            raise ValueError(f"a slab of {h0} rows: the 2x2 patches need an even count "
                             "(parallel.check_space_rows)")
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        h, w = h0 + pad_b, w0 + pad_r
        d = y.shape[-1]
        # unfold to [B, P, N, dim]: P = cells of a patch, N = patches
        y = y.reshape(b, h // ph, ph, w // pw, pw, d).permute(0, 2, 4, 1, 3, 5)
        y = y.reshape(b, ph * pw, (h // ph) * (w // pw), d)
        y = self.norm(self.transformer(y))
        y = y.reshape(b, ph, pw, h // ph, w // pw, d).permute(0, 3, 1, 4, 2, 5)
        y = y.reshape(b, h, w, d)
        if pad_b or pad_r:
            y = y[:, :h0, :w0]
        return self.conv_proj(y)


class MobileViTv2Backbone(nn.Module):
    """[B, H, W, 3] -> the [/2, /4, /8, /16, /32] pyramid with channels
    (64, 128, 256, 384, 512)."""

    def __init__(self):
        super().__init__()
        c, vit_dims, vit_depths = (64, 128, 256, 384, 512), (128, 192, 256), (2, 4, 3)
        self.conv_stem = ConvNormAct(3, 32, 3, stride=2)
        self.block0 = nn.Sequential(BottleneckBlock(32, c[0], 1))
        self.block1 = nn.Sequential(BottleneckBlock(c[0], c[1], 2), BottleneckBlock(c[1], c[1], 1))
        self.block2 = nn.Sequential(BottleneckBlock(c[1], c[2], 2),
                                    MobileVitV2Block(c[2], vit_dims[0], vit_depths[0]))
        self.block3 = nn.Sequential(BottleneckBlock(c[2], c[3], 2),
                                    MobileVitV2Block(c[3], vit_dims[1], vit_depths[1]))
        self.block4 = nn.Sequential(BottleneckBlock(c[3], c[4], 2),
                                    MobileVitV2Block(c[4], vit_dims[2], vit_depths[2]))

    def forward(self, x):
        x2 = self.block0(self.conv_stem(x))
        x4 = self.block1(x2)
        x8 = self.block2(x4)
        x16 = self.block3(x8)
        x32 = self.block4(x16)
        return [x2, x4, x8, x16, x32]
