"""Visualization: KITTI-style disparity error colormap and label colorizer
(a copy of ``semstereo_tpu/utils/visualization.py``, which is numpy only;
the original torch code's ``utils/visualization.py`` and ``mask_vis.py``,
vectorized over the colormap bins).
"""

from __future__ import annotations

import numpy as np

# (lo, hi, r, g, b) error bins in units of abs_thres, colors in [0,1]
_ERROR_COLS = np.array(
    [
        [0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
        [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
        [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
        [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
        [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
        [3 / 3.0, 6 / 3.0, 254, 224, 144],
        [6 / 3.0, 12 / 3.0, 253, 174, 97],
        [12 / 3.0, 24 / 3.0, 244, 109, 67],
        [24 / 3.0, 48 / 3.0, 215, 48, 39],
        [48 / 3.0, np.inf, 165, 0, 38],
    ],
    dtype=np.float32,
)
_ERROR_COLS[:, 2:] /= 255.0

LABEL_COLORS = np.array(
    [
        [0, 0, 0],  # class 0: black
        [255, 0, 0],  # 1: red
        [0, 255, 0],  # 2: green
        [0, 0, 255],  # 3: blue
        [255, 255, 0],  # 4: yellow
        [0, 255, 255],  # 5: cyan
    ],
    dtype=np.float32,
)


def disp_error_image(d_est, d_gt, abs_thres: float = 3.0, rel_thres: float = 0.05):
    """Color-coded disparity error image.  d_est, d_gt: [B, H, W] (numpy).
    Returns [B, H, W, 3] float RGB; invalid (gt<=0) pixels are black; a color
    legend strip is drawn in the top-left corner like the reference."""
    d_est = np.asarray(d_est, np.float32)
    d_gt = np.asarray(d_gt, np.float32)
    b, h, w = d_gt.shape
    mask = d_gt > 0
    err = np.abs(d_gt - d_est)
    rel = np.where(
        mask, np.minimum(err / abs_thres, err / np.maximum(np.abs(d_gt), 1e-12) / rel_thres), 0.0)
    img = np.zeros((b, h, w, 3), np.float32)
    for lo, hi, r, g, bb in _ERROR_COLS:
        sel = (rel >= lo) & (rel < hi)
        img[sel] = (r, g, bb)
    img[~mask] = 0.0
    strip = 20
    for i, (_, _, r, g, bb) in enumerate(_ERROR_COLS):
        img[:, :10, i * strip : (i + 1) * strip] = (r, g, bb)
    return img


def label_vis(logits):
    """Argmax class map -> RGB mask.  logits: [B, H, W, C] -> [B, H, W, 3]."""
    ids = np.argmax(np.asarray(logits), axis=-1)
    return LABEL_COLORS[np.clip(ids, 0, len(LABEL_COLORS) - 1)]
