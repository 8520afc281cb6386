"""K4 (``csrc/gwc_volume_bwd.cu``) against a variant of its own source, on
one card in one process.

    python3 -m semstereo_tpu_torch.ab_gwc_bwd OLD NEW [OLD NEW ...]

Builds the source as it is (A) and with each text OLD replaced by its NEW (B),
each by nvcc into ``_build/ab/``; checks that B gives A's result bit for
bit; and times both at the main path's shape (bf16, features
[2, 128, 128, 256], G = 32, symmetric max_shift 8) in turns A B B A over
five rounds, each round the median of 20 CUDA-event timings with L2
scrubbed before each.  Prints the card's name and power limit, then one
JSON line: per variant the median of its rounds, every round, its blocks
per SM and its shared memory per block.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

from semstereo_tpu_torch.ops import _build
from semstereo_tpu_torch.ops.cost_volume import bind_bwd, shift_range

SHAPE, GROUPS, MAX_SHIFT = (2, 128, 128, 256), 32, 8
ROUNDS, REPS = 5, 20


def build(text: str, name: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"lib{name}.so"
    src.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
                    str(src)], check=True)
    return bind_bwd(ctypes.CDLL(str(lib)))


def timed_ms(fn, scrub: torch.Tensor) -> float:
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(REPS)]
    torch.cuda._sleep(50_000_000)  # keeps the device busy while the host enqueues
    for a, b in ev:
        scrub.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def main() -> int:
    edits = list(zip(sys.argv[1::2], sys.argv[2::2]))
    if not edits or len(sys.argv) % 2 == 0 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    text = variant = (_build.CSRC / "gwc_volume_bwd.cu").read_text()
    for old, new in edits:
        if old not in variant:
            raise SystemExit(f"{old!r} is not in the source")
        variant = variant.replace(old, new)
    libs = {"A": build(text, "gwc_volume_bwd_a"), "B": build(variant, "gwc_volume_bwd_b")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, w, c = SHAPE
    lo, d = shift_range(MAX_SHIFT, True)
    left, right = (torch.randn(SHAPE, device="cuda", generator=gen).bfloat16() for _ in range(2))
    gbar = torch.randn((b, d, h, w, GROUPS), device="cuda", generator=gen).bfloat16()
    outs = {k: (torch.empty_like(left), torch.empty_like(right)) for k in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def call(k):
        err = libs[k].gwc_volume_bwd(left.data_ptr(), right.data_ptr(), gbar.data_ptr(),
                                     outs[k][0].data_ptr(), outs[k][1].data_ptr(), b, h, w, c,
                                     GROUPS, lo, d, 1, stream)
        _build.check(err, f"gwc_volume_bwd {k}")

    for k in libs:
        call(k)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(outs["A"], outs["B"])):
        raise AssertionError("B's result differs from A's")
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rounds = {k: [] for k in libs}
    for _ in range(ROUNDS):
        for k in "ABBA":
            rounds[k].append(timed_ms(lambda: call(k), scrub))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    res = {k: dict(ms=statistics.median(v), rounds=v,
                   blocks_per_sm=libs[k].gwc_volume_bwd_blocks_per_sm(c, GROUPS, d, 1),
                   smem_bytes=libs[k].gwc_volume_bwd_smem(c, GROUPS, d, 1))
           for k, v in rounds.items()}
    print(json.dumps(dict(edits=edits, device=torch.cuda.get_device_name(0), **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
