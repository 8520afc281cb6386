"""The benchmark's own tests (``python3 -m pytest stereobench/tests``).
The card's tests take the ``card`` fixture, which skips without a CUDA
device; everything else runs on the CPU at tiny sizes."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    return torch.device("cuda")


def tiny_cell(name: str, dtype: str = "float32", batch: int | None = None):
    """A cell of BENCHMARK.json at a CPU test's size: maxdisp 16, top-k 4,
    attention windows (1, 2, 2), 64x64 tiles, a pool of 3 batches."""
    from stereobench import cell as cells

    c = cells.load(name)
    c.config, c.traffic = copy.deepcopy(c.config), dict(c.traffic)
    c.config["model"].update(maxdisp=16, topk=4, att_window1=[1, 2, 2], att_window2=[1, 2, 2])
    c.config["compute_dtype"] = dtype
    c.config["tile"] = [64, 64]
    c.traffic.update(height=64, width=64, pool=3, shift_range=[-8, 8])
    if batch is not None:
        c.traffic["batch"] = batch
    return c
