"""Disparity warping of the right view (counterpart of
``semstereo_tpu/ops/warp.py``).

``grid_sample(align_corners=True, padding_mode='zeros')`` along W reduces to
a two-tap horizontal gather and lerp: sample column ``x - d``.  Coordinates
are computed in float32 whatever the feature dtype: the bf16 ulp is 1.0 for
|x| >= 128, which would collapse the bilinear weights to nearest-neighbour
over most of a wide image.  Only the lerp weights take the feature dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _coords(disp_samples: torch.Tensor, w: int):
    """Floor tap index (int64) and fraction (fp32) of ``x - d``."""
    disp = disp_samples.to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=disp.device) - disp
    x0 = torch.floor(xs)
    return x0.to(torch.int64), xs - x0


def disparity_warp(right: torch.Tensor, disp_samples: torch.Tensor) -> torch.Tensor:
    """right [B, H, W, C], disp_samples [B, D, H, W] -> warped [B, D, H, W, C];
    out-of-image taps are 0."""
    b, h, w, _ = right.shape
    x0, frac = _coords(disp_samples, w)
    # one zero column on each side: every tap left of / right of the image
    # clamps onto it
    rp = F.pad(right, (0, 0, 1, 1))
    bi = torch.arange(b, device=right.device)[:, None, None, None]
    hi = torch.arange(h, device=right.device)[None, None, :, None]
    t0 = rp[bi, hi, x0.clamp(-1, w) + 1]  # [B, D, H, W, C]
    t1 = rp[bi, hi, (x0 + 1).clamp(-1, w) + 1]
    return torch.lerp(t0, t1, frac.to(right.dtype)[..., None])


def warp_strength(left: torch.Tensor, right: torch.Tensor, disp_samples: torch.Tensor,
                  max_offset: int, min_offset: int | None = None) -> torch.Tensor:
    """``mean_c(left * disparity_warp(right, disp))`` without the warp:
    correlate over the static source-offset band [min_offset, max_offset+1]
    first (C reduced once per offset), then lerp the two bracketing
    correlation planes per pixel.

    left, right [B, H, W, C]; disp_samples [B, D, H, W] -> [B, D, H, W].
    """
    _, _, w, _ = right.shape
    hi = int(max_offset)
    lo = -hi if min_offset is None else int(min_offset)
    if not lo <= 0 <= hi + 1:
        raise ValueError(f"offset band [{lo}, {hi}] must hold 0")
    n_off = hi - lo + 2
    # corr[b, o, h, x] = mean_c l[b,h,x,c] * r[b,h,x+lo+o,c], zero off-image
    padded = F.pad(right, (0, 0, -lo, hi + 1))
    corr = torch.stack(
        [torch.mean(left * padded[:, :, o: o + w], dim=-1) for o in range(n_off)], dim=1
    )  # [B, O, H, W]

    x0, frac = _coords(disp_samples, w)
    o0 = x0 - torch.arange(w, device=x0.device) - lo  # band index of the floor tap
    cp = F.pad(corr, (0, 0, 0, 0, 1, 1))  # zero plane at each end of the band
    t0 = torch.gather(cp, 1, o0.clamp(-1, n_off) + 1)
    t1 = torch.gather(cp, 1, (o0 + 1).clamp(-1, n_off) + 1)
    return torch.lerp(t0, t1, frac.to(corr.dtype))


def warp_with_left(left: torch.Tensor, right: torch.Tensor, disp_samples: torch.Tensor):
    """(warped right, left broadcast over the D samples), both [B, D, H, W, C]."""
    warped = disparity_warp(right, disp_samples)
    left_tiled = left[:, None].expand(-1, disp_samples.shape[1], -1, -1, -1)
    return warped, left_tiled
