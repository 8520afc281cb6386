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

On the card the backward is the resize's adjoint taken one axis at a time,
each input sample's cotangent summed over the outputs that read it in a
fixed order, in fp32 or wider (``_Resize``): ``F.interpolate``'s own backward
adds them there with atomics, in an order that changes from run to run, so
a train step would not repeat itself bit for bit.  On the CPU its backward
runs in a fixed order already and is kept.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from semstereo_tpu_torch.parallel import halo_pad


@functools.lru_cache(maxsize=None)
def _taps(n: int, size: int, device: torch.device,
          dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(index [K, n], weight [K, n]) on ``device``: for each of ``n`` input
    samples, the outputs of their half-pixel linear resize to ``size`` that
    read it and with what weight (``F.interpolate``'s clamped source index
    and lambdas), zero-padded to the largest count K."""
    reads = [[] for _ in range(n)]
    for o in range(size):
        src = max(n / size * (o + 0.5) - 0.5, 0.0)
        i0 = int(src)
        i1 = i0 + (i0 < n - 1)
        reads[i0].append((o, 1.0 - (src - i0)))
        reads[i1].append((o, src - i0))
    k = max(map(len, reads))
    index = torch.zeros(k, n, dtype=torch.long)
    weight = torch.zeros(k, n, dtype=torch.float64)
    for i, taps in enumerate(reads):
        for j, (o, w) in enumerate(taps):
            index[j, i], weight[j, i] = o, w
    return index.to(device), weight.to(device, dtype)


def _adjoint(g: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """The adjoint along ``axis`` of the resize of ``n`` samples to
    ``g.shape[axis]``, in fp32 or wider."""
    acc = torch.promote_types(g.dtype, torch.float32)
    index, weight = _taps(n, g.shape[axis], g.device, acc)
    bcast = (n,) + (1,) * (g.dim() - axis - 1)
    gx = None
    for k in range(index.shape[0]):
        term = g.index_select(axis, index[k]).to(acc) * weight[k].view(bcast)
        gx = term if gx is None else gx + term
    return gx


class _Resize(torch.autograd.Function):
    """``F.interpolate(x, size, mode, align_corners=False)`` on [B, C, ...]
    with the fixed-order backward of the module docstring."""

    @staticmethod
    def forward(ctx, x, size, mode):
        ctx.in_size = x.shape[2:]
        return F.interpolate(x, size=size, mode=mode, align_corners=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gx = g
        for axis in reversed(range(len(ctx.in_size))):
            gx = _adjoint(gx, axis + 2, ctx.in_size[axis])
        return gx.to(g.dtype), None, None


def _interpolate(x: torch.Tensor, size: tuple, mode: str) -> torch.Tensor:
    """``F.interpolate(align_corners=False)`` on [B, C, ...], through
    ``_Resize`` on the card (module docstring)."""
    if x.is_cuda:
        return _Resize.apply(x, size, mode)
    return F.interpolate(x, size=size, mode=mode, align_corners=False)


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
    y = _interpolate(x.permute(0, 3, 1, 2), tuple(out_hw), "bilinear").permute(0, 2, 3, 1)
    return y if keep is None else y.narrow(1, *keep)


def resize_trilinear(x: torch.Tensor, out_dhw: tuple[int, int, int], rows=None) -> torch.Tensor:
    """Trilinear resize of [B, D, H, W, C] volumes to (D', H', W'); on row
    slabs with ``rows``, H and H' being the slab's."""
    keep = None
    if rows is not None:
        x, h, keep = _rows_halo(x, out_dhw[1], rows, 2)
        out_dhw = (out_dhw[0], h, out_dhw[2])
    y = _interpolate(x.permute(0, 4, 1, 2, 3), tuple(out_dhw),
                     "trilinear").permute(0, 2, 3, 4, 1)
    return y if keep is None else y.narrow(2, *keep)
