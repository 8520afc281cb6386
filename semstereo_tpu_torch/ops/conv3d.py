"""3x3x3 pad-1 volume convolution.

* ``conv3d_bn_act``: the conv with a per-channel affine and optional ReLU,
  the eval ``BasicConv(dims=3)`` with BatchNorm folded.  Counterpart of
  ``semstereo_tpu/ops/pallas/conv3d_wl.py::conv3d_wl_affine`` (the TPU
  kernels ``_fwd_s1`` and ``_fwd_s2``).  On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/conv3d.cu`` (K1; its note says what
  bounds it and what its design does about that); on a CPU tensor it runs
  ``conv3d_bn_act_plain``, the same function in plain PyTorch, which the
  tests and ``chip_smoke.py`` hold the kernel against.
* ``conv3d``: the differentiable conv of the train graph, counterpart of
  ``conv3d_wl.conv3d_wl`` and its VJP (``_vjp_fwd``/``_vjp_bwd``).  Its
  forward is K1 with scale 1 and bias 0; its backward follows ``_vjp_bwd``:
  the ReLU mask from the saved output, the stride-1 dx as K1 on the output
  gradient with the flipped, channel-swapped weight, the stride-2 dx as the
  k3 s2 p1 transposed conv (a library call, as the JAX package leaves it to
  XLA) and dw by ``conv3d_weight_grad``, which on a CUDA tensor launches the
  hand-written Hopper kernel ``csrc/conv3d_wgrad.cu`` and on a CPU tensor
  runs ``conv3d_weight_grad_plain`` (27 tap contractions).
  ``conv3d_plain`` (fp32 ``F.conv3d`` and autograd) is the yardstick.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from semstereo_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def out_dims(d: int, h: int, w: int, stride: int) -> tuple[int, int, int]:
    """Output extent of a k3 pad-1 conv."""
    return tuple((n - 1) // stride + 1 for n in (d, h, w))


def conv3d_bn_act_plain(x, w, scale, bias, stride: int = 1, relu: bool = False):
    """Plain PyTorch version: fp32 conv, affine, ReLU, cast to x's dtype.
    x [B,D,H,W,C], w [3,3,3,C,F], scale/bias [F] -> [B,OD,OH,OW,F]."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2),
                 stride=stride, padding=1)
    y = y.permute(0, 2, 3, 4, 1) * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _lib():
    lib = _build.load("conv3d")
    fn = lib.conv3d_bn_act
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def _check(x, w, scale, bias, stride):
    if x.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.dim() != 5 or w.shape[3] != x.shape[4]:
        raise ValueError(f"conv3d_bn_act: x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "form a [B,D,H,W,C] x [3,3,3,C,F] conv")
    f = w.shape[4]
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"conv3d_bn_act: scale/bias must be [{f}]")
    if stride not in (1, 2):
        raise ValueError(f"conv3d_bn_act: stride {stride} (takes 1 or 2)")


def conv3d_bn_act(x, w, scale, bias, stride: int = 1, relu: bool = False):
    """y = [relu](conv3d(x, w, stride, pad 1) * scale + bias), fp32 accumulation,
    y in x's dtype.  x [B,D,H,W,C], w [3,3,3,C,F], scale/bias [F]."""
    _check(x, w, scale, bias, stride)
    if x.device.type == "cpu":
        return conv3d_bn_act_plain(x, w, scale, bias, stride, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_bn_act: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv3d_bn_act: x {x.dtype}, w {w.dtype} (takes float32 or bfloat16, alike)")
    if x.dtype == torch.bfloat16 and x.shape[4] % 8 and x.shape[4] > 8:
        raise ValueError(f"conv3d_bn_act: bf16 kernel takes C % 8 == 0 or C < 8, got C={x.shape[4]}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("conv3d_bn_act: scale and bias must be float32")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"conv3d_bn_act: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"conv3d_bn_act: {name} must be contiguous")
    b, d, h, wd, c = x.shape
    f = w.shape[4]
    y = torch.empty((b, *out_dims(d, h, wd, stride), f), dtype=x.dtype, device=x.device)
    err = _lib().conv3d_bn_act(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        b, d, h, wd, c, f, stride, int(relu), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv3d_bn_act")
    if stride == 1:
        conv3d_bn_act.launches_s1 += 1
    else:
        conv3d_bn_act.launches_s2 += 1
    return y


# Kernel launches, per stride; the smoke run reads them to show that the
# main path went through the kernel.
conv3d_bn_act.launches_s1 = 0
conv3d_bn_act.launches_s2 = 0


# --- the differentiable conv of the train graph ------------------------------


def conv3d_plain(x, w, stride: int = 1, relu: bool = False):
    """Plain PyTorch version of ``conv3d``: fp32 ``F.conv3d`` with autograd,
    cast to x's dtype.  x [B,D,H,W,C], w [F,C,3,3,3] -> [B,OD,OH,OW,F]."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float(), stride=stride, padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def conv3d_input_grad_s1(gy, w3):
    """dx of the stride-1 conv: the stride-1 conv of gy with the flipped,
    channel-swapped weight, through ``conv3d_bn_act`` (K1 on the card; a
    one-channel gy, from a Cout=1 conv, takes its narrow-input path).
    gy [B,D,H,W,F], w3 [3,3,3,C,F] -> [B,D,H,W,C]."""
    wflip = torch.flip(w3, (0, 1, 2)).transpose(3, 4)  # [3,3,3,F,C]
    ones = torch.ones(w3.shape[3], dtype=torch.float32, device=gy.device)
    dx = conv3d_bn_act(gy.contiguous(), wflip.contiguous(), ones, torch.zeros_like(ones), 1)
    if dx.is_cuda:
        conv3d_input_grad_s1.launches += 1
    return dx


# K1 launches made for a stride-1 dx (each also counted in
# conv3d_bn_act.launches_s1); the smoke run reads it to show that the train
# path's backward went through the kernel.
conv3d_input_grad_s1.launches = 0


def conv3d_input_grad_s2(gy, w, in_dims):
    """dx of the stride-2 conv: the k3 s2 p1 transposed conv of gy, with
    the output padding that restores ``in_dims`` (D, H, W).  gy
    [B,OD,OH,OW,F], w [F,C,3,3,3] -> [B,D,H,W,C]."""
    op = tuple(n - (2 * o - 1) for n, o in zip(in_dims, gy.shape[1:4]))
    dx = F.conv_transpose3d(gy.permute(0, 4, 1, 2, 3), w, stride=2, padding=1,
                            output_padding=op)
    return dx.permute(0, 2, 3, 4, 1)


def conv3d_weight_grad_plain(x, gy, stride: int):
    """Plain PyTorch version of ``conv3d_weight_grad``: for each of the 27
    taps, the [C, M] x [M, F] contraction of the input voxels the tap reads
    with gy.

    Every tap is one matrix product on contiguous row ranges, with no copy
    per tap: x is zero-padded and split into its stride**3 phases (for
    stride 2, phase (pd, ph, pw) holds the padded voxels of that parity),
    each flattened over a grid G = (OD, OH, OW) + (3 - stride), and gy is
    placed at the origin of the same grid with zeros around it.  Tap k
    reads phase k % stride at grid offset k // stride, so its input rows
    are the flat rows ``off .. off + n`` of its phase, where ``off`` is
    that offset flattened; the zero rows of gy cancel the rows that wrap
    across a grid edge."""
    b, d, h, w, c = x.shape
    _, od, oh, ow, f = gy.shape
    s = stride
    g = [o + 3 - s for o in (od, oh, ow)]
    xp = F.pad(x, (0, 0, 1, s * g[2] - w - 1, 1, s * g[1] - h - 1, 1, s * g[0] - d - 1))
    phases = xp.reshape(b, g[0], s, g[1], s, g[2], s, c).permute(2, 4, 6, 0, 1, 3, 5, 7)
    phases = phases.reshape(s, s, s, -1, c)  # a view at stride 1, a copy at 2
    gp = gy.new_zeros((b, *g, f))
    gp[:, :od, :oh, :ow] = gy
    gflat = gp.reshape(-1, f)
    k = 2 // s  # the largest grid offset
    n = gflat.shape[0] - (k * g[1] + k) * g[2] - k
    taps = []
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                off = ((kd // s) * g[1] + kh // s) * g[2] + kw // s
                a = phases[kd % s, kh % s, kw % s, off:off + n]
                taps.append(torch.matmul(a.t(), gflat[:n]))
    return torch.stack(taps).reshape(3, 3, 3, c, f)


def _wgrad_lib():
    lib = _build.load("conv3d_wgrad")
    if lib.conv3d_wgrad.argtypes is None:
        lib.conv3d_wgrad.argtypes = [_P, _P, _P] + [_I] * 9 + [_P]
        lib.conv3d_wgrad.restype = ctypes.c_int
        lib.conv3d_wgrad_splits.argtypes = [_I] * 8
        lib.conv3d_wgrad_splits.restype = ctypes.c_int
    return lib


def conv3d_weight_grad(x, gy, stride: int):
    """dw [3,3,3,C,F] of the 3x3x3 pad-1 conv, in x's dtype:
    dw[tap, c, f] = sum over output voxels o of x[b, s*o - 1 + tap, c] *
    gy[b, o, f], with fp32 sums.  x [B,D,H,W,C], gy [B,OD,OH,OW,F].

    On a CUDA tensor it launches ``csrc/conv3d_wgrad.cu`` (bf16 tensor
    cores, or fp32 CUDA cores), which writes fp32 partial sums per voxel
    split; their sum over the splits, in a fixed order, is dw."""
    if x.dim() != 5 or gy.dim() != 5 or stride not in (1, 2):
        raise ValueError(f"conv3d_weight_grad: x {tuple(x.shape)}, gy {tuple(gy.shape)}, "
                         f"stride {stride}")
    b, d, h, w, c = x.shape
    f = gy.shape[4]
    if tuple(gy.shape[:4]) != (b, *out_dims(d, h, w, stride)):
        raise ValueError(f"conv3d_weight_grad: gy {tuple(gy.shape)} is not the stride-{stride} "
                         f"output of x {tuple(x.shape)}")
    if x.device.type == "cpu" and gy.device.type == "cpu":
        return conv3d_weight_grad_plain(x, gy, stride)
    if x.device.type != "cuda" or gy.device != x.device:
        raise ValueError(f"conv3d_weight_grad: no kernel for x on {x.device}, gy on {gy.device}")
    if x.dtype not in _DTYPES or gy.dtype != x.dtype:
        raise TypeError(f"conv3d_weight_grad: x {x.dtype}, gy {gy.dtype} "
                        "(takes float32 or bfloat16, alike)")
    if x.dtype == torch.bfloat16 and c % 8:
        raise ValueError(f"conv3d_weight_grad: bf16 kernel takes C % 8 == 0, got C={c}")
    if not (x.is_contiguous() and gy.is_contiguous()):
        raise ValueError("conv3d_weight_grad: x and gy must be contiguous")
    lib = _wgrad_lib()
    dt = _DTYPES[x.dtype]
    splits = lib.conv3d_wgrad_splits(b, d, h, w, c, f, stride, dt)
    part = torch.empty((splits, 27, c, f), dtype=torch.float32, device=x.device)
    err = lib.conv3d_wgrad(x.data_ptr(), gy.data_ptr(), part.data_ptr(), splits, b, d, h, w, c,
                           f, stride, dt, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3d_weight_grad")
    conv3d_weight_grad.launches += 1
    return part.sum(0).reshape(3, 3, 3, c, f).to(x.dtype)


# Kernel launches; the smoke run reads them to show that the train path's
# dw went through the kernel.
conv3d_weight_grad.launches = 0


def conv3d_forward(x, w, stride: int, relu: bool = False):
    """``conv3d``'s forward without autograd: K1 with scale 1 and bias 0."""
    w3 = w.permute(2, 3, 4, 1, 0).contiguous()  # [3,3,3,C,F]
    ones = torch.ones(w.shape[0], dtype=torch.float32, device=x.device)
    return conv3d_bn_act(x.contiguous(), w3, ones, torch.zeros_like(ones), stride, relu)


def conv3d_backward(x, w, gy, stride: int, need_dx: bool = True, need_dw: bool = True):
    """(dx, dw) of ``conv3d`` without ReLU for the output cotangent ``gy``
    (each None where not needed): ``_vjp_bwd``'s split, see the module
    docstring."""
    gy = gy.contiguous()
    dx = dw = None
    if need_dx:
        if stride == 1:
            dx = conv3d_input_grad_s1(gy, w.permute(2, 3, 4, 1, 0).contiguous())
        else:
            dx = conv3d_input_grad_s2(gy, w, x.shape[1:4])
    if need_dw:
        dw = conv3d_weight_grad(x.contiguous(), gy, stride).permute(4, 3, 0, 1, 2).to(w.dtype)
    return dx, dw


class _Conv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, relu):
        y = conv3d_forward(x, w, stride, relu)
        ctx.stride, ctx.relu = stride, relu
        ctx.save_for_backward(x, w, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        if ctx.relu:
            gy = torch.where(y > 0, gy, 0)
        dx, dw = conv3d_backward(x, w, gy, ctx.stride, *ctx.needs_input_grad[:2])
        return dx, dw, None, None


def conv3d(x, w, stride: int = 1, relu: bool = False):
    """Differentiable 3x3x3 pad-1 conv, [relu](conv3d(x, w, stride)).
    x [B,D,H,W,C]; w [F,C,3,3,3] (torch layout, so that its gradient lands
    on the ``nn.Conv3d`` weight) -> [B,OD,OH,OW,F] in x's dtype."""
    if w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"conv3d: weight {tuple(w.shape)} is not [F,C,3,3,3]")
    return _Conv3d.apply(x, w, stride, relu)
