"""Data augmentation: asymmetric photometric jitter, random crop, random
right-image occlusion, random vertical-disparity perturbation (a copy of
``semstereo_tpu/data/transforms.py``, which is numpy, PIL and scipy only).

The original torch code's SceneFlow augmentation and ``RandomVdisp``, with
no cv2 and no torchvision.  Every transform takes and returns numpy arrays
and an explicit ``np.random.Generator``, so the input pipeline is seedable
per epoch and per sample.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img.astype(np.float32) * factor, 0, 255).astype(np.uint8)


def adjust_gamma(img: np.ndarray, gamma: float) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return np.clip(255.0 * np.power(x, gamma), 0, 255).astype(np.uint8)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """torchvision semantics: blend with the mean of the grayscale image."""
    gray_mean = np.asarray(Image.fromarray(img).convert("L"), np.float32).mean()
    return np.clip(
        factor * img.astype(np.float32) + (1 - factor) * gray_mean, 0, 255
    ).astype(np.uint8)


def photometric_jitter(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Asymmetric jitter applied independently per view (reference draws
    brightness U(0.5,2), gamma U(0.8,1.2) and two contrast factors — the
    'saturation' draw is fed to adjust_contrast, sceneflow aug :60-68)."""
    img = adjust_brightness(img, rng.uniform(0.5, 2.0))
    img = adjust_gamma(img, rng.uniform(0.8, 1.2))
    img = adjust_contrast(img, rng.uniform(0.8, 1.2))
    img = adjust_contrast(img, rng.uniform(0.0, 1.4))
    return img


def random_crop(arrays, size, rng: np.random.Generator):
    """Crop every [H, W, ...] array in ``arrays`` at one random (y, x)."""
    th, tw = size
    h, w = arrays[0].shape[:2]
    th, tw = min(th, h), min(tw, w)
    y = int(rng.integers(0, h - th + 1))
    x = int(rng.integers(0, w - tw + 1))
    return [a[y : y + th, x : x + tw] for a in arrays]


def random_occlusion(
    right: np.ndarray, rng: np.random.Generator, p: float = 0.5
) -> np.ndarray:
    """Fill a random rectangle of the right image with its mean color.
    Probability ``p``: 0.5 for SceneFlow (reference sceneflow aug :91-97),
    0.2 for Cityscapes (cityscapes_dataset_c.py:121)."""
    if rng.binomial(1, p):
        right = right.copy()
        sx = int(rng.uniform(35, 100))
        sy = int(rng.uniform(25, 75))
        cx = int(rng.uniform(sx, max(right.shape[0] - sx, sx + 1)))
        cy = int(rng.uniform(sy, max(right.shape[1] - sy, sy + 1)))
        right[cx - sx : cx + sx, cy - sy : cy + sy] = right.mean(axis=(0, 1))
    return right


def vdisp_warp(
    right: np.ndarray, angle_deg: float, px2: float, center_xy: tuple[float, float]
) -> np.ndarray:
    """Deterministic core of RandomVdisp with EXACT cv2 semantics
    (reference flow_transforms.py:138-159): rotate by ``angle_deg`` (CCW in
    cv2's x-right/y-down frame) about ``center_xy`` = (cx, cy), then shift
    down by ``px2`` rows — each as one bilinear inverse-map resample with
    constant-0 border, like the reference's two cv2.warpAffine calls.

    cv2.getRotationMatrix2D gives M = [[a, b, (1-a)cx - b*cy],
    [-b, a, b*cx + (1-a)cy]] with a=cos, b=sin; warpAffine inverts it:
    dst(x,y) = src(M^-1 [x,y,1]).  Expressed in (row, col) coordinates for
    ndimage.affine_transform (output[o] = input[A o + off])."""
    from scipy import ndimage

    out = right.astype(np.float32)
    a, b = np.cos(np.deg2rad(angle_deg)), np.sin(np.deg2rad(angle_deg))
    cx, cy = center_xy
    tx, ty = (1 - a) * cx - b * cy, b * cx + (1 - a) * cy
    # inverse map in (row=y, col=x): src_y = a*y + b*x + off_y, src_x = -b*y + a*x + off_x
    mat = np.array([[a, b], [-b, a]], np.float64)
    off = np.array([-(a * ty + b * tx), -(a * tx - b * ty)], np.float64)
    # mode='grid-constant': blend edge pixels with 0 like cv2's constant
    # border (scipy's plain 'constant' snaps to cval outside [0, n-1]
    # WITHOUT blending — a 7.5%-of-pixels border mismatch, measured).
    out = np.stack(
        [
            ndimage.affine_transform(
                out[..., c], mat, offset=off, order=1, mode="grid-constant"
            )
            for c in range(out.shape[-1])
        ],
        axis=-1,
    )
    out = np.stack(
        [
            ndimage.shift(out[..., c], (px2, 0.0), order=1, mode="grid-constant")
            for c in range(out.shape[-1])
        ],
        axis=-1,
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def random_vdisp(right: np.ndarray, angle: float, px: float,
                 rng: np.random.Generator) -> np.ndarray:
    """Random small rotation + vertical shift of the right image
    (reference RandomVdisp, flow_transforms.py:138-159).  The rotation
    center is drawn as (uniform(0, H), uniform(0, W)) and handed to the
    rotation as its (cx, cy) — reproducing the reference quirk of feeding a
    (rows, cols)-range draw into cv2's (x, y) center argument."""
    px2 = rng.uniform(-px, px)
    ang = rng.uniform(-angle, angle)
    center = (rng.uniform(0, right.shape[0]), rng.uniform(0, right.shape[1]))
    return vdisp_warp(right, ang, px2, center)


def gt_pyramid(arr: np.ndarray, factors=(4, 8, 16)) -> dict[int, np.ndarray]:
    """Nearest-downsampled ground-truth pyramid (reference us3d_.py:178-182).
    Native C++ kernel when available, strided numpy otherwise."""
    from semstereo_tpu_torch.data import native

    arr = np.ascontiguousarray(arr, np.float32)
    out = {}
    for f in factors:
        d = native.downsample_nearest(arr, f)
        out[f] = d if d is not None else np.ascontiguousarray(arr[::f, ::f])
    return out
