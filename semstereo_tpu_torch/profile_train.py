"""Where the time of one train step goes on the card.

    python3 -m semstereo_tpu_torch.profile_train [--out DIR]

Runs the US3D stage-2 train step (bf16 compute on fp32 master parameters,
batch 2, 1024x1024, maxdisp 64, Adam, seg + LRSC losses, seeded random
weights) on one synthetic batch: 2 warm-up steps, 5 timed without the
profiler, then ``torch.profiler`` over 2 steps.  Prints one JSON line with,
per step (the ``_per_run`` keys of ``profile_eval.profiled``), the wall
time with and without the profiler, the device busy time, its idle share
against each wall time, the kernel launches and the device time by kernel
group and of the 25 costliest kernels, and the peak device memory.  The Chrome trace goes
to ``DIR/trace.json``.
"""

from __future__ import annotations

import argparse
import json

import torch

from semstereo_tpu_torch.config import TRAIN_PRESETS
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.profile_eval import profiled
from semstereo_tpu_torch.train import init_state, make_train_step

SIZE, BATCH = 1024, 2  # the main path's tile and batch per card
STEPS = 2  # profiled steps, after as many warm-up ones


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="profile_out")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    cfg = TRAIN_PRESETS["us3d_stage2"].replace(compute_dtype="bfloat16")
    state = init_state(cfg)
    batch = SyntheticStereoDataset(BATCH, SIZE, SIZE, cfg.model.maxdisp).batch(0, BATCH, "cuda")
    train_step = make_train_step(cfg)
    for _ in range(STEPS):
        train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    summary = profiled(lambda: train_step(state, batch), STEPS, args.out)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "size": SIZE, "batch": BATCH,
                      "steps": STEPS, **summary,
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
