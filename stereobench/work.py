"""Operations and bytes of the benchmark's layers, from shapes.

A kernel's least time is the larger of its operations over the card's
peak rate and its bytes over the card's memory bandwidth (``bound_s``),
counting each input byte read once and each output byte written once.
The peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, at
700 W).  The model's operations per pair come from the plain reference on
the ``meta`` device (``model_flop_per_pair``), so a later change to the
program leaves the yardstick as it is.
"""

from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}


def _size(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def bound_s(flops: float, nbytes: float, dtype: torch.dtype) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def conv3d_out(dims, stride: int):
    """Output extent of a 3x3x3 pad-1 conv."""
    return tuple((n - 1) // stride + 1 for n in dims)


def conv3d_fwd(x_shape, f: int, stride: int, dtype) -> tuple[float, float]:
    """(operations, bytes) of the 3x3x3 pad-1 conv of x [B, D, H, W, C] to
    f channels with a per-channel affine: the input, the weight and the
    output once, and the fp32 scale and bias."""
    b, d, h, w, c = x_shape
    m = b * math.prod(conv3d_out((d, h, w), stride))
    size = _size(dtype)
    return 2.0 * m * 27 * c * f, (b * d * h * w * c + 27 * c * f + m * f) * size + 8 * f


def conv3d_bwd(x_shape, f: int, stride: int, dtype, need_dx=True, need_dw=True):
    """(operations, bytes) of the conv's backward: dx and dw each a product
    of the forward's size; reads x, w and gy once, writes dx and dw once."""
    b, d, h, w, c = x_shape
    m = b * math.prod(conv3d_out((d, h, w), stride))
    size = _size(dtype)
    x, wt, gy = b * d * h * w * c, 27 * c * f, m * f
    flops = 2.0 * m * 27 * c * f * (int(need_dx) + int(need_dw))
    nbytes = (x * (1 + int(need_dx)) + wt * (1 + int(need_dw)) + gy) * size
    return flops, nbytes


def gwc_fwd(feat_shape, planes: int, dtype) -> tuple[float, float]:
    """(operations, bytes) of the cosine group-wise correlation volume of
    two [B, H, W, C] feature maps over ``planes`` shifts: the dot products
    and the two normalisations; both maps read once, the volume
    [B, D, H, W, C / 8] written once."""
    b, h, w, c = feat_shape
    size = _size(dtype)
    flops = 2.0 * planes * b * h * w * c + 4.0 * b * h * w * c
    return flops, (2 * b * h * w * c + b * planes * h * w * (c // 8)) * size


def gwc_bwd(feat_shape, planes: int, dtype) -> tuple[float, float]:
    """(operations, bytes) of its backward: both maps and the volume's
    cotangent read once, both input cotangents written once."""
    b, h, w, c = feat_shape
    size = _size(dtype)
    flops = 4.0 * planes * b * h * w * c + 16.0 * b * h * w * c
    return flops, (4 * b * h * w * c + b * planes * h * w * (c // 8)) * size


def model_flop_per_pair(model_cfg: dict, batch: int, height: int, width: int,
                        train: bool) -> float:
    """Convolution and matrix-product operations of the reference network
    per stereo pair at these shapes: the forward, and for ``train`` also
    the losses' backward (no recomputation), counted by
    ``torch.utils.flop_counter`` on the ``meta`` device."""
    from torch.utils.flop_counter import FlopCounterMode

    from stereobench import reference

    with torch.device("meta"):
        model = reference.build(model_cfg).train(train)
        left = torch.empty(batch, height, width, 3)
        right = torch.empty(batch, height, width, 3)
        counter = FlopCounterMode(display=False)
        with counter:
            if train:
                out = model(left, right)
                disp = torch.zeros(batch, height, width)
                batch_ = {"disparity": disp, "disparity_4": disp[:, ::4, ::4],
                          "label": torch.zeros(batch, height, width)}
                reference.losses(out, batch_, model_cfg["maxdisp"], model_cfg["num_classes"],
                                 model_cfg["att_weights_only"])["loss"].backward()
            else:
                with torch.no_grad():
                    model(left, right)
    return counter.get_total_flops() / batch
