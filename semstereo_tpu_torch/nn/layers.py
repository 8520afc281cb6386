"""Core blocks, channels-last (counterpart of ``semstereo_tpu/nn/layers.py``).

Tensors are [B, H, W, C] or [B, D, H, W, C].  The convs are torch modules
with the reference's weight layouts and state-dict names; they run on
permuted (channels_last / channels_last_3d strided) views, so no copies are
made around them.  Eval BatchNorm is an affine on the channel axis with
eps 1e-5.  A 3x3x3 pad-1 conv at stride 1 or 2 (``BasicConv(dims=3)``, the
hourglass ``convbn_3d`` and the classifier convs) runs in
``ops.conv3d_bn_act`` with its BN folded in: ``scale = gamma /
sqrt(var + 1e-5)``, ``bias = beta - mean * scale``; every other conv and
deconv stays on ``F.conv*``.  What the eval forward derives from the weights
(the BN affine, the kernel's weight layout) is computed once and kept on the
module until the weights change (``derived``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from semstereo_tpu_torch.ops.conv3d import conv3d_bn_act
from semstereo_tpu_torch.ops.resize import resize_bilinear


def derived(module: nn.Module, dtype: torch.dtype, sources, make):
    """``make()``, kept on ``module`` while ``dtype`` and the tensors in
    ``sources`` stay as they are.  An in-place write (loading weights
    included) moves a tensor's version; ``.to()`` gives it new storage."""
    key = (dtype, *((t.device, t.data_ptr(), t._version) for t in sources))
    hit = module.__dict__.get("_derived")
    if hit is None or hit[0] != key:
        hit = module.__dict__["_derived"] = (key, make())
    return hit[1]


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis (torch BatchNorm names:
    weight, bias, running_mean, running_var)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale, shift) with y = x * scale + shift."""
        scale = self.weight.detach().float() / torch.sqrt(self.running_var.float() + self.eps)
        shift = self.bias.detach().float() - self.running_mean.float() * scale
        return scale, shift

    def forward(self, x):
        scale, shift = derived(self, x.dtype, (self.weight, self.bias, self.running_mean,
                                               self.running_var),
                               lambda: tuple(t.to(x.dtype) for t in self.fold()))
        return torch.addcmul(shift, x, scale)


def conv_cl(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Run a torch conv module (NC... layout) on a channels-last tensor."""
    nd = x.dim() - 2
    y = conv(x.permute(0, nd + 1, *range(1, nd + 1)))
    return y.permute(0, *range(2, nd + 2), 1)


def _is_k3_volume_conv(conv: nn.Module) -> bool:
    return (
        type(conv) is nn.Conv3d
        and conv.kernel_size == (3, 3, 3)
        and conv.padding == (1, 1, 1)
        and conv.stride in ((1, 1, 1), (2, 2, 2))
        and conv.dilation == (1, 1, 1)
        and conv.groups == 1
        and conv.bias is None
    )


def kernel_operands(conv: nn.Conv3d, bn: BatchNorm | None):
    """The kernel's weight [3, 3, 3, C, F] and fp32 scale and bias [F]: the
    folded BN, or 1 and 0 without one."""
    w = conv.weight.detach().permute(2, 3, 4, 1, 0).contiguous()
    if bn is not None:
        return (w, *bn.fold())
    ones = torch.ones(conv.out_channels, dtype=torch.float32, device=w.device)
    return w, ones, torch.zeros_like(ones)


def conv_bn_act(conv: nn.Module, bn: BatchNorm | None, x: torch.Tensor,
                relu: bool) -> torch.Tensor:
    """[relu](bn(conv(x))); a 3x3x3 pad-1 volume conv goes to the kernel."""
    if _is_k3_volume_conv(conv):
        sources = (conv.weight,) if bn is None else (
            conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        w, scale, shift = derived(conv, conv.weight.dtype, sources,
                                  lambda: kernel_operands(conv, bn))
        return conv3d_bn_act(x.contiguous(), w, scale, shift, conv.stride[0], relu)
    y = conv_cl(conv, x)
    if bn is not None:
        y = bn(y)
    return torch.relu(y) if relu else y


def make_conv(cin: int, cout: int, k, stride=1, padding=0, dims: int = 2, deconv=False,
              output_padding=0, bias: bool = False) -> nn.Module:
    if deconv:
        cls = nn.ConvTranspose3d if dims == 3 else nn.ConvTranspose2d
        return cls(cin, cout, k, stride, padding, output_padding, bias=bias)
    cls = nn.Conv3d if dims == 3 else nn.Conv2d
    return cls(cin, cout, k, stride, padding, bias=bias)


class BasicConv(nn.Module):
    """(De)conv without bias + BN + ReLU (children ``conv``, ``bn``)."""

    def __init__(self, cin: int, cout: int, kernel_size=3, stride=1, padding=0, dims=2,
                 deconv=False):
        super().__init__()
        self.conv = make_conv(cin, cout, kernel_size, stride, padding, dims, deconv)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return conv_bn_act(self.conv, self.bn, x, relu=True)


class ConvBn(nn.Sequential):
    """Sequential(conv, BN): children ``0`` and ``1`` (reference ``convbn_3d``
    and the ``chal_*`` reductions)."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0, dims=2,
                 bias=False, deconv=False, output_padding=0):
        super().__init__(
            make_conv(cin, cout, kernel_size, stride, padding, dims, deconv, output_padding,
                      bias=bias),
            BatchNorm(cout),
        )

    def forward(self, x, relu: bool = False):
        return conv_bn_act(self[0], self[1], x, relu)


class Conv2x(nn.Module):
    """k4 s2 p1 deconv (exact x2 upsample), bilinear shape-fix to the skip,
    concat, 3x3 conv (``conv1``, ``conv2``); output has 2 * ``cout`` channels."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = BasicConv(cin, cout, 4, 2, 1, deconv=True)
        self.conv2 = BasicConv(2 * cout, 2 * cout, 3, 1, 1)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[1:-1] != rem.shape[1:-1]:
            x = resize_bilinear(x, rem.shape[1:3])
        return self.conv2(torch.cat([x, rem], dim=-1))
