"""Resize ops with ``F.interpolate(align_corners=False)`` semantics.

Counterpart of ``semstereo_tpu/ops/resize.py``.  Every call site in the model
upsamples, where the JAX package's ``jax.image.resize(method='linear')``
equals torch's half-pixel bilinear/trilinear interpolation.

Row slabs (``rows``, a mesh whose space axis splits the images): at an
integer scale s along H, output row o of the whole reads input rows
floor((o + 0.5) / s - 0.5) and the next, clamped to the image.  So the
slab of input rows [a, a + n) gives output rows [s a, s (a + n)) once it has
one row of each neighbour (``parallel.halo_pad``, copies of the edge row
past the image, which is the clamp): the haloed slab of n + 2 rows,
resized to s (n + 2) rows, holds the slab's output rows at s .. s (n + 1) -
1, each computed from the same two rows with the same weights as in the
whole image (the source position of every kept row is the whole image's,
both scales being exactly 1 / s), to the rounding of the interpolation
(one fp32 ulp on the CPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semstereo_tpu_torch.parallel import halo_pad


def _rows_halo(x: torch.Tensor, out_h: int, rows, axis: int):
    """(the input with one replicated row each side, its output height,
    the output rows to keep) for the slab ``x`` resized to ``out_h`` rows."""
    n = x.shape[axis]
    if out_h % n:
        raise ValueError(f"a slab of {n} rows resized to {out_h}: not an integer scale")
    s = out_h // n
    return halo_pad(x, rows.space_part, axis, 1, 1, mode="replicate"), s * (n + 2), (s, out_h)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], rows=None) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] images to (H', W'); on row slabs
    with ``rows`` (module docstring), H and H' being the slab's."""
    keep = None
    if rows is not None:
        x, h, keep = _rows_halo(x, out_hw[0], rows, 1)
        out_hw = (h, out_hw[1])
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1)
    return y if keep is None else y.narrow(1, *keep)


def resize_trilinear(x: torch.Tensor, out_dhw: tuple[int, int, int], rows=None) -> torch.Tensor:
    """Trilinear resize of [B, D, H, W, C] volumes to (D', H', W'); on row
    slabs with ``rows``, H and H' being the slab's."""
    keep = None
    if rows is not None:
        x, h, keep = _rows_halo(x, out_dhw[1], rows, 2)
        out_dhw = (out_dhw[0], h, out_dhw[2])
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=tuple(out_dhw), mode="trilinear",
                      align_corners=False).permute(0, 2, 3, 4, 1)
    return y if keep is None else y.narrow(2, *keep)
