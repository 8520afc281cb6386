"""Computing the reference in a lower precision than the configuration's,
for the control.

The configurations compute in bf16 (every activation rounded to bf16, the
master weights in fp32), so the control takes the next step down and
computes in fp8: under ``Fp8Compute`` every floating tensor that a torch
function returns is rounded to e4m3, each tensor scaled so that its
largest magnitude is 448, while the arithmetic inside each function stays
fp32.  The weights are rounded where they are read.  The rounding passes
the gradient straight through, so the backward runs in fp32 on the fp8
forward's values, as a training step on fp8 activations has them.

``Fp8Operands`` is the narrower step a program would take on FP8 tensor
cores: only the two operands of each convolution and matrix product are
rounded to e4m3 (scaled per tensor), the products accumulate in fp32, and
everything else stays fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map_only

E4M3_MAX = 448.0


class _RoundE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point() or x.numel() == 0:
        return x
    return _RoundE4M3.apply(x)


class Fp8Compute(TorchFunctionMode):
    """Every floating tensor a torch function returns, rounded to fp8."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        return tree_map_only(torch.Tensor, round_e4m3, out)


PRODUCTS = (F.conv2d, F.conv3d, F.conv_transpose2d, F.conv_transpose3d, F.linear, torch.matmul)


class Fp8Operands(TorchFunctionMode):
    """The input and the weight of every convolution and matrix product,
    rounded to fp8."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            args = tuple(round_e4m3(a) if i < 2 and isinstance(a, torch.Tensor) else a
                         for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))


MODES = {"fp8": Fp8Compute, "fp8_operands": Fp8Operands}
