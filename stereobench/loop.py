"""Pieces the drivers share: the device's clock wait, the seeded sample of
finished requests, freeing the program before the reference runs."""

from __future__ import annotations

import gc
import random
import statistics
import time

import torch

now = time.perf_counter


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def p95(values: list) -> float:
    """The 95th percentile of all values (linear between order statistics)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from a seed
    (Algorithm R); ``offer`` calls ``take()`` only for an item it keeps."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, take) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(take())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = take()
