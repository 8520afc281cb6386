"""Synthetic stereo pairs with exact integer-shift disparities and
piecewise-constant labels, for tests and the smoke run (a copy of
``semstereo_tpu.data.loader.SyntheticStereoDataset``)."""

from __future__ import annotations

import numpy as np
import torch


class SyntheticStereoDataset:
    """Sample ``index`` is drawn from ``numpy.random.default_rng(index)``:
    a random right view, the left view its roll by one integer disparity d,
    the constant gt ``disparity`` d (and ``disparity_4`` at /4 when
    ``training``), and one constant label below the ignore class."""

    def __init__(self, size: int, height: int, width: int, maxdisp: int,
                 num_classes: int = 6, symmetric: bool = True, training: bool = True):
        self.size = size
        self.h, self.w = height, width
        self.maxdisp = maxdisp
        self.num_classes = num_classes
        self.symmetric = symmetric
        self.training = training

    def __len__(self):
        return self.size

    def get(self, index: int) -> dict:
        rng = np.random.default_rng(index)
        h, w = self.h, self.w
        right = rng.standard_normal((h, w, 3)).astype(np.float32)
        lo = -self.maxdisp // 2 if self.symmetric else 1
        hi = self.maxdisp // 2 if self.symmetric else self.maxdisp
        d = int(rng.integers(lo, hi))
        # left pixel x corresponds to right pixel x - d
        left = np.roll(right, d, axis=1)
        disparity = np.full((h, w), float(d), np.float32)
        label = (rng.integers(0, self.num_classes - 1, (1, 1)) * np.ones((h, w))).astype(
            np.float32)
        sample = {"left": left, "right": right, "disparity": disparity, "label": label}
        if self.training:
            sample["disparity_4"] = disparity[::4, ::4].copy()
        return sample

    def batch(self, start: int, size: int, device="cpu") -> dict:
        """Samples start .. start + size - 1, stacked into tensors on ``device``."""
        samples = [self.get(i) for i in range(start, start + size)]
        return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
                for k in samples[0]}
