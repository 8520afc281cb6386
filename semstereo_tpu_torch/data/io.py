"""Image / disparity / label file readers (a copy of
``semstereo_tpu/data/io.py``, which is numpy and PIL only).

ImageNet normalization and the PFM reader of the original torch code's
``datasets/data_io.py``, plus the per-dataset readers: float TIFF
disparities and label maps (US3D), PNG/256 disparities (WHU, KITTI).
"""

from __future__ import annotations

import re

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def read_all_lines(filename: str) -> list[str]:
    with open(filename) as f:
        return [line.rstrip() for line in f if line.strip()]


def load_image_rgb(path: str) -> np.ndarray:
    """RGB uint8 image [H, W, 3]."""
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 [H,W,3] -> ImageNet-normalized float32 [H,W,3] (channels-last),
    by the native sample prep (``data/native.py``) when it is built, else
    by numpy."""
    from semstereo_tpu_torch.data import native

    out = native.normalize_image(np.ascontiguousarray(img), IMAGENET_MEAN, IMAGENET_STD)
    if out is not None:
        return out
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def load_disp_float(path: str) -> np.ndarray:
    """Float disparity stored in TIFF/PNG pixels as-is (US3D TIF tiles)."""
    return np.ascontiguousarray(Image.open(path), dtype=np.float32)


def load_disp_png256(path: str) -> np.ndarray:
    """uint16 PNG disparity scaled by 256 (KITTI / WHU convention)."""
    return np.asarray(Image.open(path), np.float32) / 256.0


def load_label(path: str) -> np.ndarray:
    """Integer label map as float32 [H, W]."""
    return np.ascontiguousarray(Image.open(path), dtype=np.float32)


def pfm_imread(path: str):
    """SceneFlow PFM reader -> (data [H,W] or [H,W,3] float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("utf-8"))
        if not dims:
            raise ValueError(f"malformed PFM header: {path}")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.ascontiguousarray(np.flipud(data.reshape(shape))), abs(scale)


def image_gradients(img: np.ndarray):
    """Standardized-grayscale horizontal/vertical gradients via [-1, 0, 1]
    kernels (the original US3D dataset's; loaded but unused by the trainer)."""
    from scipy.signal import convolve2d

    gray = np.asarray(Image.fromarray(img).convert("L"), np.float32)
    gray = (gray - gray.mean()) / max(gray.std(), 1e-12)
    gx = convolve2d(gray, np.array([[-1, 0, 1]], np.float32), "same")
    gy = convolve2d(gray, np.array([[-1], [0], [1]], np.float32), "same")
    return gx.astype(np.float32), gy.astype(np.float32)
