"""Per-block timeline of K2 (``csrc/gwc_volume.cu``, or another version of it)
on one card.

    python3 -m semstereo_tpu_torch.timeline_gwc [--source FILE]

Builds the source with a clock64 mark after every ``__syncthreads()`` of the
kernel (thread 0 of each block records the SM cycles since the block
started) into ``_build/ab/``, runs it at the eval path's shape (bf16,
features [1, 128, 128, 256], G = 32, symmetric max_shift 8) three times
with L2 scrubbed by a 64 MB write before each, and prints the card's name,
power limit and SM clock, then one JSON line: for each mark of the last run
the median and the largest cycle count over the blocks, and the spread of
the blocks' start times (ns).  It says where a block's time goes between
barriers; the marks themselves add a few cycles each.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from semstereo_tpu_torch.ops import _build
from semstereo_tpu_torch.ops.cost_volume import shift_range

SHAPE, GROUPS, MAX_SHIFT = (1, 128, 128, 256), 32, 8
BLOCKS, MARKS = 1024, 32

_GLOBALS = f"""
__device__ long long tl_marks[{BLOCKS * MARKS}];
__device__ unsigned long long tl_start[{BLOCKS}];
"""
_START = f"""
  const long long tl_t0 = clock64();
  const int tl_b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  int tl_k = 0;
  if (threadIdx.x == 0 && tl_b < {BLOCKS}) {{
    unsigned long long gt;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));
    tl_start[tl_b] = gt;
  }}
"""
_MARK = (f"__syncthreads(); if (threadIdx.x == 0 && tl_b < {BLOCKS} && tl_k < {MARKS}) "
         f"tl_marks[tl_b * {MARKS} + tl_k] = clock64() - tl_t0; ++tl_k;")
_READ = f"""
extern "C" int tl_read(long long* marks, unsigned long long* start) {{
  cudaMemcpyFromSymbol(marks, tl_marks, sizeof(long long) * {BLOCKS * MARKS});
  return (int)cudaMemcpyFromSymbol(start, tl_start, sizeof(unsigned long long) * {BLOCKS});
}}
"""
_SHARED = "extern __shared__ __align__(16) unsigned char smem[];\n"


def instrument(text: str) -> str:
    """The source with the timeline's marks added."""
    if text.count(_SHARED) != 1 or "namespace {" not in text:
        raise SystemExit("the source has no single kernel with dynamic shared memory")
    head, kernel = text.split(_SHARED)
    head = head.replace("namespace {", _GLOBALS + "namespace {", 1)
    return head + _SHARED + _START + kernel.replace("__syncthreads();", _MARK) + _READ


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available() or (args and (len(args) != 2 or args[0] != "--source")):
        print(__doc__)
        return 1
    text = Path(args[1]).read_text() if args else (_build.CSRC / "gwc_volume.cu").read_text()
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    src, lib_path = out / "gwc_volume_timeline.cu", out / "libgwc_volume_timeline.so"
    src.write_text(instrument(text))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.gwc_volume.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.tl_read.argtypes = [ctypes.c_void_p] * 2
    b, h, w, c = SHAPE
    lo, d = shift_range(MAX_SHIFT, True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    left, right = (torch.randn(SHAPE, device="cuda", generator=gen).bfloat16() for _ in range(2))
    vol = torch.empty((b, d, h, w, GROUPS), dtype=torch.bfloat16, device="cuda")
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        scrub.zero_()
        _build.check(lib.gwc_volume(left.data_ptr(), right.data_ptr(), vol.data_ptr(), b, h, w,
                                    c, GROUPS, lo, d, 1, torch.cuda.current_stream().cuda_stream),
                     "gwc_volume (timeline)")
    torch.cuda.synchronize()
    marks = (ctypes.c_longlong * (BLOCKS * MARKS))()
    start = (ctypes.c_ulonglong * BLOCKS)()
    lib.tl_read(marks, start)
    nblocks = next((k for k in range(BLOCKS) if start[k] == 0), BLOCKS)
    rows = [marks[k * MARKS:(k + 1) * MARKS] for k in range(nblocks)]
    nmarks = next((k for k in range(MARKS) if all(r[k] == 0 for r in rows)), MARKS)
    starts = [start[k] - min(start[:nblocks]) for k in range(nblocks)]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps(dict(
        source=args[1] if args else "csrc/gwc_volume.cu", blocks=nblocks,
        start_ns=dict(median=statistics.median(starts), max=max(starts)),
        marks_cycles=[dict(median=statistics.median(r[k] for r in rows),
                           max=max(r[k] for r in rows)) for k in range(nmarks)])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
