"""SemStereo in plain PyTorch: the yardstick the benchmark holds the port to.

A frozen copy of the model's mathematics (arXiv:2412.12685, as the US3D
recipe of the reference repository runs it), written with plain ``torch``
operations only: ``F.conv*`` for every convolution, the group-wise
correlation volume as a loop over its shifts, ``F.interpolate`` for the
resizes.  It imports nothing of the port.  Its state-dict keys and shapes
are the reference repository's, which the port shares, so one state dict
loads into both.

Layouts are channels-last: images [B, H, W, C], volumes [B, D, H, W, C].
The model runs in fp32; ``SemStereo(..., precision="fp8")`` computes its
forward in fp8 instead (``precision.py``), the control's precision, and
``precision="fp8_operands"`` rounds only the operands of its products.

BatchNorm: in eval an affine by the running statistics (eps 1e-5); in
train the batch statistics over every axis but the last, the biased
variance, and the running statistics moved 0.1 of the way to them.  The
two views go through the front end in two passes, left then right.
GroupNorm(1) uses eps 1e-6.

Hard choices: the top-k planes of the /8 attention (stage 1) and the
refine top-k of the /4 cost (stage 2) are where an untrained net's
disparity turns on rounding (a near-tie flips).  ``forward(left, right,
choices)`` takes them from the program (``choices['topk']`` [B, H/4, W/4,
k] plane indices ascending, ``choices['refine']`` [B, H/4, W/4,
refine_topk] indices into the k samples) and returns in ``margins`` how far
each choice is from its own (``choice_violation``; its own choices, taken
or followed, are in ``choices``).

With ``lean``, each top-level module of a train forward is recomputed in
the backward (``torch.utils.checkpoint``), which changes no value: the
batch-4 fp32 step at 1024x1024 does not fit the card otherwise.  BatchNorm
then moves its running statistics twice, which a train forward never reads.

Output (dict), disparities [B, H, W]:
  train, stage 2: disp = (pred_up*4, pred*4, pred_att_up*4, pred_att*4)
  train, stage 1: disp = (pred_att_up*4, pred_att*4)
  eval:           disp = (pred_up*4,), or (pred_att_up*4,) in stage 1
  label_l, label_r: [B, H, W, num_classes] logits.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from stereobench.reference.precision import MODES

CHANS = (128, 256, 512, 768, 512)
CHANS2 = (64, 128, 256, 384, 256)
GN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ATT_HEADS = 16


def conv(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv or deconv module on a channels-last tensor."""
    nd = x.dim() - 2
    xc, w = x.permute(0, nd + 1, *range(1, nd + 1)), module.weight
    kw = dict(stride=module.stride, padding=module.padding, groups=module.groups,
              dilation=module.dilation)
    if isinstance(module, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
        y = fn(xc, w, module.bias, output_padding=module.output_padding, **kw)
    else:
        y = (F.conv2d if nd == 2 else F.conv3d)(xc, w, module.bias, **kw)
    return y.permute(0, *range(2, nd + 2), 1)


def pointwise(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv or a Linear on the last axis."""
    return F.linear(x, module.weight.reshape(module.weight.shape[0], -1), module.bias)


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel (align_corners=False) bilinear or trilinear resize of a
    channels-last tensor."""
    nd = x.dim() - 2
    mode = "bilinear" if nd == 2 else "trilinear"
    y = F.interpolate(x.permute(0, nd + 1, *range(1, nd + 1)), size=tuple(size), mode=mode,
                      align_corners=False)
    return y.permute(0, *range(2, nd + 2), 1)


class BatchNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        if not self.training:
            return (x - self.running_mean) / torch.sqrt(self.running_var + BN_EPS) \
                * self.weight + self.bias
        dims = tuple(range(x.dim() - 1))
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        with torch.no_grad():
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        return (x - mean) / torch.sqrt(var + BN_EPS) * self.weight + self.bias


class GroupNorm1(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        dims = tuple(range(1, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
        return (x - mean) / torch.sqrt(var + GN_EPS) * self.weight + self.bias


# --- backbone: MobileViTv2 1.0 ------------------------------------------------


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, groups=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(conv(self.conv, x))
        return F.silu(x) if self.act else x


class BottleneckBlock(nn.Module):
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
    """Separable self-attention on [B, P, N, C]: a softmax over the patches
    N of one score channel weights the keys into one context vector, which
    gates the ReLU of the values."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.qkv_proj = nn.Conv2d(dim, 1 + 2 * dim, 1)
        self.out_proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        q, k, v = torch.split(pointwise(self.qkv_proj, x), [1, self.dim, self.dim], dim=-1)
        context = torch.sum(k * torch.softmax(q, dim=2), dim=2, keepdim=True)
        return pointwise(self.out_proj, torch.relu(v) * context)


class LinearTransformerBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm1 = GroupNorm1(dim)
        self.attn = LinearSelfAttention(dim)
        self.norm2 = GroupNorm1(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Conv2d(dim, 2 * dim, 1)
        self.mlp.fc2 = nn.Conv2d(2 * dim, dim, 1)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + pointwise(self.mlp.fc2, F.silu(pointwise(self.mlp.fc1, self.norm2(x))))


class MobileVitV2Block(nn.Module):
    def __init__(self, cin, dim, depth):
        super().__init__()
        self.conv_kxk = ConvNormAct(cin, cin, 3, groups=cin)
        self.conv_1x1 = nn.Conv2d(cin, dim, 1, bias=False)
        self.transformer = nn.Sequential(*[LinearTransformerBlock(dim) for _ in range(depth)])
        self.norm = GroupNorm1(dim)
        self.conv_proj = ConvNormAct(dim, cin, 1, act=False)

    def forward(self, x):
        b, h0, w0, _ = x.shape
        y = pointwise(self.conv_1x1, self.conv_kxk(x))
        pad_b, pad_r = h0 % 2, w0 % 2
        y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        h, w, d = h0 + pad_b, w0 + pad_r, y.shape[-1]
        # 2x2 patches: [B, P = 4 cells of a patch, N = patches, dim]
        y = y.reshape(b, h // 2, 2, w // 2, 2, d).permute(0, 2, 4, 1, 3, 5)
        y = self.norm(self.transformer(y.reshape(b, 4, (h // 2) * (w // 2), d)))
        y = y.reshape(b, 2, 2, h // 2, w // 2, d).permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, d)
        return self.conv_proj(y[:, :h0, :w0])


class Backbone(nn.Module):
    """[B, H, W, 3] -> the /2 .. /32 pyramid, channels (64, 128, 256, 384, 512)."""

    def __init__(self):
        super().__init__()
        c = (64, 128, 256, 384, 512)
        self.conv_stem = ConvNormAct(3, 32, 3, stride=2)
        self.block0 = nn.Sequential(BottleneckBlock(32, c[0], 1))
        self.block1 = nn.Sequential(BottleneckBlock(c[0], c[1], 2), BottleneckBlock(c[1], c[1]))
        self.block2 = nn.Sequential(BottleneckBlock(c[1], c[2], 2), MobileVitV2Block(c[2], 128, 2))
        self.block3 = nn.Sequential(BottleneckBlock(c[2], c[3], 2), MobileVitV2Block(c[3], 192, 4))
        self.block4 = nn.Sequential(BottleneckBlock(c[3], c[4], 2), MobileVitV2Block(c[4], 256, 3))

    def forward(self, x):
        feats = [self.block0(self.conv_stem(x))]
        for block in (self.block1, self.block2, self.block3, self.block4):
            feats.append(block(feats[-1]))
        return feats


# --- 2-D and 3-D blocks -----------------------------------------------------


def _make_conv(cin, cout, k, stride=1, padding=0, dims=2, deconv=False, output_padding=0,
               bias=False):
    if deconv:
        cls = nn.ConvTranspose3d if dims == 3 else nn.ConvTranspose2d
        return cls(cin, cout, k, stride, padding, output_padding, bias=bias)
    return (nn.Conv3d if dims == 3 else nn.Conv2d)(cin, cout, k, stride, padding, bias=bias)


class BasicConv(nn.Module):
    """conv (no bias) -> BatchNorm -> ReLU."""

    def __init__(self, cin, cout, k=3, stride=1, padding=0, dims=2, deconv=False):
        super().__init__()
        self.conv = _make_conv(cin, cout, k, stride, padding, dims, deconv)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(conv(self.conv, x)))


class ConvBn(nn.Sequential):
    """Sequential(conv, BatchNorm)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dims=2, bias=False, deconv=False,
                 output_padding=0):
        super().__init__(_make_conv(cin, cout, k, stride, padding, dims, deconv, output_padding,
                                    bias), BatchNorm(cout))

    def forward(self, x, relu=False):
        y = self[1](conv(self[0], x))
        return torch.relu(y) if relu else y


class Conv2x(nn.Module):
    """k4 s2 p1 deconv, bilinear fix to the skip's size, concat, 3x3 conv."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = BasicConv(cin, cout, 4, 2, 1, deconv=True)
        self.conv2 = BasicConv(2 * cout, 2 * cout, 3, 1, 1)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[1:3] != rem.shape[1:3]:
            x = resize(x, rem.shape[1:3])
        return self.conv2(torch.cat([x, rem], dim=-1))


class FeatUp(nn.Module):
    def __init__(self):
        super().__init__()
        self.deconv32_16 = Conv2x(512, 384)
        self.deconv16_8 = Conv2x(2 * 384, 256)
        self.deconv8_4 = Conv2x(2 * 256, 128)
        self.deconv4_2 = Conv2x(2 * 128, 64)

    def forward(self, feats):
        x2, x4, x8, x16, x32 = feats
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.deconv8_4(x8, x4)
        x2 = self.deconv4_2(x4, x2)
        return [x2, x4, x8, x16, x32]


class SegmentHead(nn.Module):
    def __init__(self, cin, inter, nc):
        super().__init__()
        self.conv1 = BasicConv(cin, inter, 3, 1, 1)
        self.conv2 = nn.Conv2d(inter, nc, 1)

    def forward(self, x):
        return resize(conv(self.conv2, self.conv1(x)), (2 * x.shape[1], 2 * x.shape[2]))


class ChannelAtt(nn.Module):
    def __init__(self, cv_channels, im_channels):
        super().__init__()
        self.im_att = nn.Sequential(BasicConv(im_channels, im_channels // 2, 1, 1, 0),
                                    nn.Conv2d(im_channels // 2, cv_channels, 1))

    def forward(self, cv, im):
        return torch.sigmoid(conv(self.im_att[1], self.im_att[0](im)))[:, None] * cv


class SSRUpsample(nn.Module):
    """x4 bilinear disparity plus a residual gated by the label posterior
    and the superpixel weights."""

    def __init__(self, nc):
        super().__init__()
        self.conv = nn.Sequential(BatchNorm(1), nn.Conv2d(1, nc, 3, 1, 1), BatchNorm(nc))
        self.conv1 = nn.Sequential(nn.Conv2d(nc, nc, 1), BatchNorm(nc))
        self.conv2 = nn.Sequential(nn.Conv2d(nc, nc, 1), BatchNorm(nc))
        self.conv3 = nn.Conv2d(nc, 1, 1)

    def forward(self, depth_low, spx, label):
        _, h, w, _ = depth_low.shape
        depth_up = resize(depth_low, (4 * h, 4 * w))
        d = self.conv[2](conv(self.conv[1], self.conv[0](depth_up)))
        p = torch.sigmoid(self.conv1[1](conv(self.conv1[0], torch.softmax(label, -1) * spx)))
        p = torch.sigmoid(self.conv2[1](conv(self.conv2[0], p * spx)))
        return (depth_up + conv(self.conv3, d * p))[..., 0]


class WindowedAttention3D(nn.Module):
    """16-head self-attention within (bd, bh, bw) windows of a volume; the
    volume is zero-padded to whole windows and a -1000 bias keeps padded
    and real cells apart."""

    def __init__(self, c, window):
        super().__init__()
        self.window = tuple(window)
        self.qkv_3d = nn.Linear(c, 3 * c)
        self.final1x1 = nn.Conv3d(c, c, 1)

    def forward(self, x):
        b, d0, h0, w0, c = x.shape
        bd, bh, bw = self.window
        d, h, w = -(-d0 // bd) * bd, -(-h0 // bh) * bh, -(-w0 // bw) * bw
        x = F.pad(x, (0, 0, 0, w - w0, 0, h - h0, 0, d - d0))
        n, t, hd = (d // bd) * (h // bh) * (w // bw), bd * bh * bw, c // ATT_HEADS
        xw = x.reshape(b, d // bd, bd, h // bh, bh, w // bw, bw, c)
        xw = xw.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, n, t, c)
        qkv = pointwise(self.qkv_3d, xw).reshape(b, n, t, 3, ATT_HEADS, hd)
        q, k, v = (qkv[..., i, :, :].transpose(2, 3) for i in range(3))
        attn = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        if (d, h, w) != (d0, h0, w0):
            pad = torch.zeros((d, h, w), dtype=torch.bool, device=x.device)
            pad[d0:], pad[:, h0:], pad[:, :, w0:] = True, True, True
            pad = pad.reshape(d // bd, bd, h // bh, bh, w // bw, bw).permute(0, 2, 4, 1, 3, 5)
            pad = pad.reshape(n, t)
            attn = attn + ((pad[:, None, :] != pad[:, :, None]) * -1000.0)[None, :, None]
        out = torch.matmul(torch.softmax(attn, -1), v).transpose(2, 3)
        out = out.reshape(b, d // bd, h // bh, w // bw, bd, bh, bw, c)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)[:, :d0, :h0, :w0]
        return pointwise(self.final1x1, out)


class Hourglass3D(nn.Module):
    def __init__(self, c, window):
        super().__init__()
        self.conv1 = nn.Sequential(ConvBn(c, 2 * c, 3, 2, 1, dims=3), nn.ReLU())
        self.conv2 = nn.Sequential(ConvBn(2 * c, 2 * c, 3, 1, 1, dims=3), nn.ReLU())
        self.conv3 = nn.Sequential(ConvBn(2 * c, 4 * c, 3, 2, 1, dims=3), nn.ReLU())
        self.conv4 = nn.Sequential(ConvBn(4 * c, 4 * c, 3, 1, 1, dims=3), nn.ReLU())
        self.attention_block = WindowedAttention3D(4 * c, window)
        self.conv5 = ConvBn(4 * c, 2 * c, 3, 2, 1, dims=3, deconv=True, output_padding=1)
        self.conv6 = ConvBn(2 * c, c, 3, 2, 1, dims=3, deconv=True, output_padding=1)
        self.redir1 = ConvBn(c, c, 1, dims=3)
        self.redir2 = ConvBn(2 * c, 2 * c, 1, dims=3)

    def forward(self, x):
        c1 = self.conv1[0](x, relu=True)
        c2 = self.conv2[0](c1, relu=True)
        c3 = self.conv3[0](c2, relu=True)
        c4 = self.attention_block(self.conv4[0](c3, relu=True))
        c5 = torch.relu(self.conv5(c4) + self.redir2(c2))
        return torch.relu(self.conv6(c5) + self.redir1(x))


class Classifier3D(nn.Sequential):
    def __init__(self, c):
        super().__init__(ConvBn(c, c, 3, 1, 1, dims=3), nn.ReLU(),
                         nn.Conv3d(c, 1, 3, 1, 1, bias=False))

    def forward(self, x):
        return conv(self[2], self[0](x, relu=True))


class ConcatFeature(nn.Sequential):
    def __init__(self):
        super().__init__(BasicConv(CHANS2[1], CHANS2[1] // 2, 3, 1, 1),
                         nn.Conv2d(CHANS2[1] // 2, CHANS2[1] // 4, 3, 1, 1, bias=False))

    def forward(self, x):
        return conv(self[1], self[0](x))


# --- volume operations ------------------------------------------------------


def gwc_volume(left, right, max_shift: int, groups: int, symmetric: bool):
    """Cosine group-wise correlation: plane d holds shift s = d - max_shift
    (symmetric) or d, vol[b,d,h,x,g] = mean_c ln[b,h,x,g,c] rn[b,h,x-s,g,c]
    for x - s inside the image, else 0; ln, rn normalised per group (eps
    added to the norm).  -> [B, D, H, W, G]."""
    b, h, w, c = left.shape

    def unit(f):
        f = f.reshape(b, h, w, groups, c // groups)
        return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-5)

    ln, rn = unit(left), unit(right)
    shifts = range(-max_shift, max_shift) if symmetric else range(max_shift)
    planes = []
    for s in shifts:
        r = torch.zeros_like(rn)
        if s >= 0:
            r[:, :, s:] = rn[:, :, :w - s]
        else:
            r[:, :, :w + s] = rn[:, :, -s:]
        planes.append(torch.mean(ln * r, dim=-1))
    return torch.stack(planes, dim=1)


def disparity_values(n: int, symmetric: bool, like: torch.Tensor):
    lo = -(n // 2) if symmetric else 0
    return torch.arange(lo, lo + n, dtype=like.dtype, device=like.device)


def propagate5(x):
    """[B, C, H, W] -> [B, 5, C, H, W]: the centre and four diagonal
    neighbours (NW, C, SE, SW, NE) of the edge-replicated map."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    taps = ((-1, -1), (0, 0), (1, 1), (1, -1), (-1, 1))
    return torch.stack([xp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy, dx in taps], 1)


def _linear_taps(disp, w):
    """Floor column and fraction of x - d, in fp32."""
    xs = torch.arange(w, dtype=torch.float32, device=disp.device) - disp.float()
    x0 = torch.floor(xs)
    return x0.long(), xs - x0


def warp(right, disp):
    """right [B, H, W, C] sampled at columns x - disp [B, D, H, W] by linear
    interpolation, zero outside the image -> [B, D, H, W, C]."""
    b, h, w, _ = right.shape
    x0, frac = _linear_taps(disp, w)
    rp = F.pad(right, (0, 0, 1, 1))
    bi = torch.arange(b, device=right.device)[:, None, None, None]
    hi = torch.arange(h, device=right.device)[None, None, :, None]
    t0 = rp[bi, hi, x0.clamp(-1, w) + 1]
    t1 = rp[bi, hi, (x0 + 1).clamp(-1, w) + 1]
    return t0 + (t1 - t0) * frac[..., None]


def warp_correlation(left, right, disp):
    """mean_c(left * warp(right, disp)) -> [B, D, H, W]."""
    return torch.mean(left[:, None] * warp(right, disp), dim=-1)


def topk_indices(x, k: int):
    """The k largest along the last axis, ties to the lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def choice_violation(weights, kept) -> torch.Tensor:
    """How far the choice ``kept`` [..., k] is from the best k of weights
    [..., N]: the mean over pixels of the positive part of (the best weight
    left out - the worst kept) over the weights' range at the pixel; 0
    where the choice is the best k everywhere."""
    w = weights.detach().float()
    gap = w.scatter(-1, kept, float("-inf")).amax(-1) - torch.gather(w, -1, kept).amin(-1)
    return (gap / (w.amax(-1) - w.amin(-1)).clamp_min(1e-30)).clamp_min(0).mean()


# --- the network --------------------------------------------------------------


class _Inside(contextlib.AbstractContextManager):
    def __init__(self, model):
        self.model, self.mode = model, MODES[model.precision]()

    def __enter__(self):
        self.model._inside = True
        self.mode.__enter__()

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        self.model._inside = False


class SemStereo(nn.Module):
    def __init__(self, maxdisp=64, num_classes=6, att_weights_only=False, symmetric=True,
                 topk=24, refine_topk=2, att_window1=(4, 4, 4), att_window2=(6, 4, 4),
                 precision=None, lean=False):
        super().__init__()
        if precision is not None and precision not in MODES:
            raise ValueError(f"precision {precision!r}: None (fp32) or one of {sorted(MODES)}")
        self.lean, self.precision = lean, precision
        self._inside = False
        self.maxdisp, self.num_classes = maxdisp, num_classes
        self.att_weights_only, self.symmetric = att_weights_only, symmetric
        self.topk, self.refine_topk = topk, refine_topk
        nc = num_classes
        self.feature = Backbone()
        self.feature_up = FeatUp()
        self.head_l = SegmentHead(CHANS[0], CHANS[0] // 4, nc)
        self.head_r = SegmentHead(CHANS[0], CHANS[0] // 4, nc)
        for i in range(5):
            self.add_module(f"chal_{i}", ConvBn(CHANS[i], CHANS2[i], 1, bias=True))
        self.spx32_16 = Conv2x(CHANS2[4], CHANS2[3])
        self.spx16_8 = Conv2x(CHANS2[3] * 2, CHANS2[2])
        self.spx8_4 = Conv2x(CHANS2[2] * 2, CHANS2[1])
        self.spx4_2 = Conv2x(CHANS2[1] * 2, CHANS2[0])
        self.spx2 = nn.Sequential(nn.ConvTranspose2d(CHANS2[0] * 2, nc, 4, 2, 1))
        g = CHANS2[2] // 8
        self.patch = nn.Conv3d(g, g, (1, 3, 3), 1, (0, 1, 1), groups=g, bias=False)
        self.corr_feature_att_8 = ChannelAtt(g, CHANS2[2])
        self.hourglass_att = Hourglass3D(32, att_window1)
        self.classif_att_ = Classifier3D(32)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.beta = nn.Parameter(torch.full((1,), 2.0))
        self.ssr_upsample = SSRUpsample(nc)
        if not att_weights_only:
            self.concat_feature = ConcatFeature()
            self.concat_stem = BasicConv(CHANS2[1] // 2, CHANS2[1] // 4, 3, 1, 1, dims=3)
            self.concat_feature_att_4 = ChannelAtt(CHANS2[1] // 4, CHANS2[1])
            self.hourglass = Hourglass3D(32, att_window2)
            self.classif = Classifier3D(32)

    def _mode(self):
        """The precision's mode, entered once (a recomputation in the
        backward enters it again)."""
        if self.precision is None or self._inside:
            return contextlib.nullcontext()
        return _Inside(self)

    def _run(self, module, *args):
        if self.lean and self.training and torch.is_grad_enabled():
            def fn(*a):
                with self._mode():
                    return module(*a)
            return checkpoint(fn, *args, use_reentrant=False)
        return module(*args)

    def forward(self, left, right, choices=None):
        with self._mode():
            return self._forward(left, right, choices)

    def _forward(self, left, right, choices):
        train, run = self.training, self._run
        feat_l = run(self.feature_up, run(self.feature, left))
        feat_r = run(self.feature_up, run(self.feature, right))
        label_l = run(self.head_l, feat_l[0])
        out = {"label_l": label_l, "label_r": run(self.head_r, feat_r[0]), "margins": {}}
        fl = [run(getattr(self, f"chal_{i}"), feat_l[i]) for i in range(5)]
        fr1, fr2 = run(self.chal_1, feat_r[1]), run(self.chal_2, feat_r[2])

        x = run(self.spx32_16, fl[4], fl[3])
        x = run(self.spx16_8, x, fl[2])
        x = run(self.spx8_4, x, fl[1])
        x = run(self.spx4_2, x, fl[0])
        spx = conv(self.spx2[0], x)

        # stage 1: the /8 cosine attention volume
        corr = conv(self.patch, gwc_volume(fl[2], fr2, self.maxdisp // 8, CHANS2[2] // 8,
                                           self.symmetric))
        cost_att = run(self.corr_feature_att_8, corr, fl[2])
        cost_att = run(self.classif_att_, run(self.hourglass_att, cost_att))
        d4 = self.maxdisp // 4 * (2 if self.symmetric else 1)
        h4, w4 = left.shape[1] // 4, left.shape[2] // 4
        att_w = resize(cost_att, (d4, h4, w4))[..., 0]  # [B, D4, H4, W4]
        prob = torch.softmax(att_w, dim=1)
        vals = disparity_values(d4, self.symmetric, prob)[None, :, None, None]
        pred_att = torch.sum(prob * vals, dim=1)
        var = torch.sum(prob * torch.square(vals - pred_att[:, None]), dim=1)
        conf = torch.sigmoid(self.beta[0] + self.gamma[0] * var)
        conf5 = propagate5(conf[:, None])[:, :, 0]
        disp5 = propagate5(pred_att[:, None])[:, :, 0]
        strength = warp_correlation(fl[1], fr1, disp5)
        strength = torch.softmax(strength * conf5, dim=1)
        att_w = torch.sum(propagate5(att_w) * strength[:, :, None], dim=1)

        k = min(self.topk, d4)
        raw = att_w.movedim(1, -1)  # [B, H4, W4, D4]
        if choices is None:
            ind = torch.sort(topk_indices(raw, k), dim=-1).values
        else:
            ind = choices["topk"]
            if k < d4:
                out["margins"]["topk_violation"] = choice_violation(raw, ind)
        out["choices"] = {"topk": ind.detach()}
        top_raw = torch.gather(raw, -1, ind)
        att_k = torch.exp(top_raw - torch.logsumexp(raw, -1, keepdim=True)).movedim(-1, 1)
        samples = (ind.to(raw.dtype) - (d4 // 2 if self.symmetric else 0)).movedim(-1, 1)
        pred_att = torch.sum(torch.softmax(top_raw, -1).movedim(-1, 1) * samples, dim=1)
        if self.att_weights_only or train:
            pred_att_up = run(self.ssr_upsample, pred_att[..., None], spx, label_l)
        if self.att_weights_only:
            out["disp"] = (pred_att_up * 4, pred_att * 4) if train else (pred_att_up * 4,)
            return out

        # stage 2: the /4 concat volume on the top-k planes
        lc, rc = run(self.concat_feature, fl[1]), run(self.concat_feature, fr1)
        volume = att_k[..., None] * torch.cat(
            [lc[:, None].expand(-1, k, -1, -1, -1), warp(rc, samples)], dim=-1)
        volume = run(self.concat_feature_att_4, run(self.concat_stem, volume), fl[1])
        cost = run(self.classif, run(self.hourglass, volume))[..., 0].movedim(1, -1)
        if choices is None:
            sel = topk_indices(cost, self.refine_topk)
        else:
            sel = choices["refine"]
            out["margins"]["refine_violation"] = choice_violation(cost, sel)
        out["choices"]["refine"] = sel.detach()
        p = torch.softmax(torch.gather(cost, -1, sel), dim=-1)
        pred = torch.sum(p * torch.gather(samples.movedim(1, -1), -1, sel), dim=-1)
        pred_up = run(self.ssr_upsample, pred[..., None], spx, label_l)
        if train:
            out["disp"] = (pred_up * 4, pred * 4, pred_att_up * 4, pred_att * 4)
        else:
            out["disp"] = (pred_up * 4,)
        return out
