"""Experiment utilities: scalar conversion, NaN-tolerant meters,
TensorBoard writers, stdout tee (counterpart of
``semstereo_tpu/utils/experiment.py``; the original torch code's
``utils/experiment.py`` meters and writers and its ``Logger1`` tee).

A ``writer`` is anything with ``add_scalar`` and ``add_image``, such as
``torch.utils.tensorboard.SummaryWriter``; the CLIs import it only under
``--tensorboard``.
"""

from __future__ import annotations

import copy
import math
import sys

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_float(x):
    if isinstance(x, torch.Tensor):
        return float(x.item()) if x.numel() == 1 else x
    return float(x) if hasattr(x, "__float__") or np.isscalar(x) else x


def tensor2float(tree):
    """Scalar leaves (0-d tensors, numpy and Python numbers) of a nested
    dict/list to Python floats; other leaves unchanged."""
    return _map(_to_float, tree)


def tensor2numpy(tree):
    """Tensor leaves to numpy arrays (moved to the host)."""
    return _map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x), tree)


class AverageMeterDict:
    """NaN-skipping batch-mean accumulator over dicts of floats or lists of
    floats: a NaN adds nothing to its sum, and every key divides by the
    number of updates."""

    def __init__(self):
        self.data: dict | None = None
        self.count = 0

    def update(self, x: dict):
        self.count += 1
        if self.data is None:
            self.data = copy.deepcopy(x)
            # NaNs in the very first update must not poison the sum
            for k, v in self.data.items():
                if isinstance(v, (list, tuple)):
                    self.data[k] = [0.0 if math.isnan(e) else e for e in v]
                elif math.isnan(v):
                    self.data[k] = 0.0
            return
        for k, v in x.items():
            if isinstance(v, (list, tuple)):
                for i, e in enumerate(v):
                    if not math.isnan(e):
                        self.data[k][i] += e
            elif not math.isnan(v):
                self.data[k] += v

    def mean(self) -> dict:
        if self.data is None:
            return {}
        return _map(lambda v: v / float(self.count), self.data)


class AverageMeterDictPerKey:
    """NaN-aware per-key-count averaging: keys that were NaN in some batches
    average over only the batches where they were finite."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def update(self, x: dict):
        for k, v in x.items():
            vals = v if isinstance(v, (list, tuple)) else [v]
            for e in vals:
                if not math.isnan(e):
                    self.sums[k] = self.sums.get(k, 0.0) + e
                    self.counts[k] = self.counts.get(k, 0) + 1

    def mean(self) -> dict:
        return {k: self.sums[k] / self.counts[k] for k in self.sums if self.counts.get(k)}


def save_scalars(writer, mode_tag: str, scalar_dict: dict, global_step: int):
    """One scalar per tag and index: ``{mode_tag}/{tag}_{idx}``."""
    scalar_dict = tensor2float(scalar_dict)
    for tag, values in scalar_dict.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        for idx, value in enumerate(values):
            writer.add_scalar(f"{mode_tag}/{tag}_{idx}", value, global_step)


def save_images(writer, mode_tag: str, images_dict: dict, global_step: int):
    """The first sample of each [B, H, W] or [B, C, H, W] entry, min-max
    normalized, as one image."""
    images_dict = tensor2numpy(images_dict)
    for tag, values in images_dict.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        for idx, value in enumerate(values):
            img = np.asarray(value)
            if img.ndim == 3:  # [B,H,W] -> [B,1,H,W]
                img = img[:, None]
            img = img[:1].astype(np.float32)
            lo, hi = img.min(), img.max()
            img = (img - lo) / max(hi - lo, 1e-12)
            name = f"{mode_tag}/{tag}" + (f"_{idx}" if len(values) > 1 else "")
            writer.add_image(name, img[0], global_step)


class TeeLogger:
    """Writes to ``stream`` (stdout by default) and appends to a logfile."""

    def __init__(self, filename: str, stream=None):
        self.terminal = stream or sys.stdout
        self.filename = filename

    def write(self, message: str):
        self.terminal.write(message)
        with open(self.filename, "a+") as f:
            f.write(message)

    def flush(self):
        self.terminal.flush()
