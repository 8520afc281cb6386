"""3x3x3 pad-1 volume convolution with a per-channel affine and optional
ReLU: the eval ``BasicConv(dims=3)`` with BatchNorm folded.

Counterpart of ``semstereo_tpu/ops/pallas/conv3d_wl.py::conv3d_wl_affine``
(the TPU kernels ``_fwd_s1`` and ``_fwd_s2``).  On a CUDA tensor
``conv3d_bn_act`` launches the hand-written Hopper kernel ``csrc/conv3d.cu``
(note there on what bounds it and what its design does about that); on a
CPU tensor it runs ``conv3d_bn_act_plain``, the same function in plain
PyTorch, which the tests and ``chip_smoke.py`` hold the kernel against.
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
    if x.dtype == torch.bfloat16 and x.shape[4] % 8:
        raise ValueError(f"conv3d_bn_act: bf16 kernel takes C % 8 == 0, got C={x.shape[4]}")
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
