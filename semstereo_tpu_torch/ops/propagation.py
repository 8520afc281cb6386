"""Fixed 5-tap spatial propagation: centre and four diagonal neighbours of an
edge-padded map (counterpart of ``semstereo_tpu/ops/propagation.py``).

Tap order NW, C, SE, SW, NE; the disparity/confidence maps and the volume
must agree on it because they multiply hypothesis-wise downstream.

On row slabs (``rows``, a mesh whose space axis splits the images) the row
above and the row below a slab are the neighbours' edge rows
(``parallel.halo_pad``); only past the image's top and bottom are they
copies of the edge row, as the whole map's replicate padding has them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semstereo_tpu_torch.parallel import halo_pad

# (dy, dx) offsets of the 5 taps.
_TAPS = ((-1, -1), (0, 0), (1, 1), (1, -1), (-1, 1))


def _taps(xp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.stack(
        [xp[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w] for dy, dx in _TAPS], dim=1
    )


def _pad(x: torch.Tensor, rows) -> torch.Tensor:
    """x [B, C, H, W] with one replicated row and column on each side (the
    rows from the neighbouring slabs with ``rows``)."""
    if rows is None:
        return F.pad(x, (1, 1, 1, 1), mode="replicate")
    x = halo_pad(x, rows.space_part, 2, 1, 1, mode="replicate")
    return F.pad(x, (1, 1, 0, 0), mode="replicate")


def propagate5(x: torch.Tensor, rows=None) -> torch.Tensor:
    """x [B, H, W] -> [B, 5, H, W]."""
    _, h, w = x.shape
    return _taps(_pad(x[:, None], rows)[:, 0], h, w)


def propagate5_volume(vol: torch.Tensor, rows=None) -> torch.Tensor:
    """vol [B, D, H, W] -> [B, 5, D, H, W], replication pad over H and W."""
    _, _, h, w = vol.shape
    return _taps(_pad(vol, rows), h, w)
