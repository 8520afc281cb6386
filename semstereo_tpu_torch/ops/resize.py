"""Resize ops with ``F.interpolate(align_corners=False)`` semantics.

Counterpart of ``semstereo_tpu/ops/resize.py``.  Every call site in the model
upsamples, where the JAX package's ``jax.image.resize(method='linear')``
equals torch's half-pixel bilinear/trilinear interpolation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] images to (H', W')."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def resize_trilinear(x: torch.Tensor, out_dhw: tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of [B, D, H, W, C] volumes to (D', H', W')."""
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=tuple(out_dhw), mode="trilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 4, 1)
