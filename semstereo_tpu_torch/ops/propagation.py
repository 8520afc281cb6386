"""Fixed 5-tap spatial propagation: centre and four diagonal neighbours of an
edge-padded map (counterpart of ``semstereo_tpu/ops/propagation.py``).

Tap order NW, C, SE, SW, NE; the disparity/confidence maps and the volume
must agree on it because they multiply hypothesis-wise downstream.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (dy, dx) offsets of the 5 taps.
_TAPS = ((-1, -1), (0, 0), (1, 1), (1, -1), (-1, 1))


def _taps(xp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.stack(
        [xp[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w] for dy, dx in _TAPS], dim=1
    )


def propagate5(x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W] -> [B, 5, H, W]."""
    _, h, w = x.shape
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return _taps(xp, h, w)


def propagate5_volume(vol: torch.Tensor) -> torch.Tensor:
    """vol [B, D, H, W] -> [B, 5, D, H, W], replication pad over H and W."""
    _, _, h, w = vol.shape
    vp = F.pad(vol, (1, 1, 1, 1), mode="replicate")
    return _taps(vp, h, w)
