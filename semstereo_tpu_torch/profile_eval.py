"""Where the time of one eval request goes on the card.

    python3 -m semstereo_tpu_torch.profile_eval [--out DIR]

Runs SemStereo US3D stage 2 (bf16, B=1, 1024x1024, maxdisp 64, seeded random
weights) on an integer-shift pair: 3 warm-up requests, then
``torch.profiler`` over 3 requests.  Prints one JSON line with the wall time per request, the device
busy time per request (the union of kernel intervals on the card), its idle
share, and the device time per request of the 25 costliest kernels and of
the groups they fall in.  The Chrome trace goes to ``DIR/trace.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from semstereo_tpu_torch.config import PRESETS
from semstereo_tpu_torch.models import build_model

SIZE = 1024  # the main path's tile
REQUESTS = 3  # profiled requests, after as many warm-up ones

# substrings of kernel names -> group (first match wins)
GROUPS = [
    ("conv3d_halo_kernel", "K1 conv3d (hand, tensor cores)"),
    ("conv3d_kernel", "K1 conv3d (hand, CUDA cores)"),
    ("gwc_volume_kernel", "K2 gwc_volume (hand)"),
    ("conv", "cuDNN conv/deconv"),
    ("gemm", "matmul (cuBLAS)"),
    ("sm90", "matmul (cuBLAS)"),
    ("softmax", "softmax"),
    ("upsample", "interpolate"),
    ("index", "gather/index"),
    ("gather", "gather/index"),
    ("topk", "topk/sort"),
    ("sort", "topk/sort"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"),
    ("vectorized", "elementwise"),
    ("copy", "copies"),
    ("cat", "copies"),
]


def _group(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="profile_out")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    model = build_model(PRESETS["us3d_stage2"], device="cuda", dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(0)
    right = torch.from_numpy(rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32))
    left = torch.roll(right, 8, dims=2)
    left, right = left.to("cuda", torch.bfloat16), right.to("cuda", torch.bfloat16)
    for _ in range(REQUESTS):
        model(left, right)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            model(left, right)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / REQUESTS
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("the trace holds no device kernels")
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels]
    busy_ms = _busy_us(intervals) / 1e3 / REQUESTS
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    by_group: dict[str, float] = {}
    for name, ms in by_name.items():
        by_group[_group(name)] = by_group.get(_group(name), 0.0) + ms / REQUESTS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "size": SIZE,
        "requests": REQUESTS, "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_request": len(kernels) / REQUESTS,
        "groups_ms_per_request": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_request": [[n[:90], ms / REQUESTS] for n, ms in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
