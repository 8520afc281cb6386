"""Cosine group-wise correlation cost volumes.

Counterpart of ``semstereo_tpu/ops/cost_volume.py``.  Layouts are
channels-last: features [B, H, W, C], volume [B, D, H, W, G].  Plane d holds
shift ``d - max_shift`` (symmetric) or ``d`` (positive):
``vol[b,d,h,x,g] = mean_c ln[b,h,x,g,c] * rn[b,h,x-s,g,c]`` for in-range
``x - s``, else 0.

On a CUDA tensor ``gwc_volume_norm`` launches the Hopper kernel
``csrc/gwc_volume.cu`` (which replaces the TPU kernel
``semstereo_tpu/ops/pallas/cost_volume_kernel.py::_forward``; its note says
what bounds it and what the design does about that).  On a CPU tensor it
runs ``gwc_volume_norm_plain``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from semstereo_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def normalize_groups(feat: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, G, C//G], unit L2 norm per group, with eps
    added to the norm (not to its square)."""
    b, h, w, c = feat.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    g = feat.reshape(b, h, w, num_groups, c // num_groups)
    norm = torch.sqrt(torch.sum(torch.square(g), dim=-1, keepdim=True))
    return g / (norm + eps)


def shift_range(max_shift: int, symmetric: bool) -> tuple[int, int]:
    """(first shift, number of planes)."""
    return (-max_shift, 2 * max_shift) if symmetric else (0, max_shift)


def gwc_volume_norm_plain(left, right, max_shift: int, num_groups: int,
                          symmetric: bool = True) -> torch.Tensor:
    """Plain PyTorch version, computed in fp32 and cast to the input dtype.
    left, right [B, H, W, C] -> [B, D, H, W, G]."""
    w = left.shape[2]
    ln = normalize_groups(left.float(), num_groups)
    rn = normalize_groups(right.float(), num_groups)
    lo, d = shift_range(max_shift, symmetric)
    hi = lo + d - 1
    # rp[:, :, j] = rn[:, :, j - max(hi, 0)]; shift s reads columns x - s
    pad_l, pad_r = max(hi, 0), max(-lo, 0)
    rp = F.pad(rn, (0, 0, 0, 0, pad_l, pad_r))
    planes = []
    for s in range(lo, lo + d):
        r_s = rp[:, :, pad_l - s: pad_l - s + w]
        planes.append(torch.mean(ln * r_s, dim=-1))
    return torch.stack(planes, dim=1).to(left.dtype)


def _lib():
    lib = _build.load("gwc_volume")
    fn = lib.gwc_volume
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def gwc_volume_norm(left, right, max_shift: int, num_groups: int,
                    symmetric: bool = True) -> torch.Tensor:
    """Cosine group-wise correlation volume; see the module docstring."""
    if left.dim() != 4 or left.shape != right.shape:
        raise ValueError(f"gwc_volume_norm: left {tuple(left.shape)}, right "
                         f"{tuple(right.shape)} (takes two equal [B,H,W,C])")
    if left.shape[3] % num_groups:
        raise ValueError(f"{left.shape[3]} channels do not split into {num_groups} groups")
    if left.device.type == "cpu":
        return gwc_volume_norm_plain(left, right, max_shift, num_groups, symmetric)
    if left.device.type != "cuda" or right.device != left.device:
        raise ValueError(f"gwc_volume_norm: no kernel for {left.device} / {right.device}")
    if left.dtype not in _DTYPES or right.dtype != left.dtype:
        raise TypeError(f"gwc_volume_norm: {left.dtype}/{right.dtype} (takes float32 or bfloat16)")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("gwc_volume_norm: left and right must be contiguous")
    b, h, w, c = left.shape
    if c * left.element_size() % 16:
        raise ValueError(f"gwc_volume_norm: kernel takes C filling 16-byte chunks, got C={c}")
    lo, d = shift_range(max_shift, symmetric)
    out = torch.empty((b, d, h, w, num_groups), dtype=left.dtype, device=left.device)
    err = _lib().gwc_volume(
        left.data_ptr(), right.data_ptr(), out.data_ptr(), b, h, w, c, num_groups, lo, d,
        _DTYPES[left.dtype], torch.cuda.current_stream(left.device).cuda_stream,
    )
    _build.check(err, "gwc_volume_norm")
    gwc_volume_norm.launches += 1
    return out


# Kernel launches; the smoke run reads it to show that the main path went
# through the kernel.
gwc_volume_norm.launches = 0
