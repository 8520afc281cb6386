"""Thread-prefetched batch loader (a copy of ``semstereo_tpu/data/loader.py``,
which is numpy only).

A seedable thread-pool pipeline that decodes and augments samples ahead of
the train step and stacks them into numpy batches.  The seeding contract is
the JAX package's, so the two give equal batches: the epoch's permutation
comes from ``seed + epoch``, sample ``i`` draws from
``default_rng((seed + 1) * 1_000_003 + epoch * 97 + i)``, and shard ``s`` of
``n`` reads ``idx[s::n]``.  One difference: with ``drop_last`` the
permutation is first cut to a whole number of global batches
(``batch_size * n`` rows), so every shard yields the same number of
batches and step s of the n shards together reads rows ``s*B .. (s+1)*B - 1``
of the permutation, the rows of step s of one shard at batch B.  The trainer
moves the batches to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into a batch dict (numpy)."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], str):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool,
        num_workers: int = 4,
        drop_last: bool = False,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.seed = seed
        self.shard_index, self.shard_count = shard
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reseed shuffling per epoch (deterministic across hosts)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        if self.drop_last:
            rows = self.batch_size * self.shard_count
            idx = idx[: len(idx) // rows * rows]
        return idx[self.shard_index :: self.shard_count]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        nb = len(self)
        batches = [idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]
        base = (self.seed + 1) * 1_000_003 + self.epoch * 97

        def load_one(i: int) -> dict:
            rng = np.random.default_rng(base + int(i))
            if hasattr(self.dataset, "get"):
                return self.dataset.get(int(i), rng)
            return self.dataset[int(i)]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(load_one, b))
                        q.put(collate(samples))
                q.put(None)
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


class SyntheticStereoDataset:
    """Synthetic random stereo pairs with exact integer-shift disparities
    and piecewise-constant labels, for tests and the smoke run.  Sample
    ``index`` is drawn from ``numpy.random.default_rng(index)`` whatever the
    ``rng`` given to ``get``: a random right view, the left view its roll by
    one integer disparity d, the constant ground truth ``disparity`` d (and
    ``disparity_4`` at /4 when ``training``), and one constant label below
    the ignore class."""

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

    def get(self, index: int, rng: np.random.Generator) -> dict:
        rng = np.random.default_rng(index)  # deterministic per sample
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
        samples = [self.get(i, None) for i in range(start, start + size)]
        return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
                for k in samples[0]}
