"""A cost-volume kernel against a variant of its source, on one card in one
process.

    python3 -m semstereo_tpu_torch.ab_gwc fwd|bwd OLD NEW [OLD NEW ...]
    python3 -m semstereo_tpu_torch.ab_gwc fwd|bwd --source FILE

``fwd`` is K2 (``csrc/gwc_volume.cu``) at the eval path's shape (features
[1, 128, 128, 256]), ``bwd`` K4 (``csrc/gwc_volume_bwd.cu``) at the train
step's ([2, 128, 128, 256]); both bf16, G = 32, symmetric max_shift 8.
Builds the source as it is (A) and a variant (B), each by nvcc into
``_build/ab/``: the source with each text OLD replaced by its NEW, or the
whole file FILE (for example an earlier version from ``git show``).
Checks both against the plain PyTorch version (max |err| / max |plain|
within 2e-2, one bf16 ulp) and says whether B gives A's result bit for
bit; then times both in turns A B B A over five rounds, each round the
median of 20 CUDA-event timings with L2 scrubbed before each: ``ms`` with
L2 scrubbed by a 64 MB write, as ``chip_smoke.py`` does (it leaves L2 full
of dirty lines, whose write-back the kernel then pays), and ``ms_clean_l2``
by a 64 MB read.  Prints the card's name and power limit, then one JSON
line: per variant the medians of its rounds, every round, and, where its
source exports them, its blocks per SM and shared memory per block.  B must
export A's C entry point with A's signature.
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
from semstereo_tpu_torch.ops import cost_volume as cv

GROUPS, MAX_SHIFT = 32, 8
BATCH = {"fwd": 1, "bwd": 2}
SOURCE = {"fwd": "gwc_volume", "bwd": "gwc_volume_bwd"}
ROUNDS, REPS = 5, 20
TOL = 2e-2


def build(text: str, name: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"lib{name}.so"
    src.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
                    str(src)], check=True)
    return ctypes.CDLL(str(lib))


def timed_ms(fn, scrub) -> float:
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(REPS)]
    torch.cuda._sleep(50_000_000)  # keeps the device busy while the host enqueues
    for a, b in ev:
        scrub()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def occupancy(lib: ctypes.CDLL, prefix: str, args) -> dict:
    """Blocks per SM and shared memory per block, where the source exports them."""
    res = {}
    for key, sym, restype in (("blocks_per_sm", f"{prefix}_blocks_per_sm", ctypes.c_int),
                              ("smem_bytes", f"{prefix}_smem", ctypes.c_longlong)):
        if hasattr(lib, sym):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = [ctypes.c_int] * 4, restype
            res[key] = fn(*args)
    return res


def main() -> int:
    args = sys.argv[1:]
    if len(args) < 2 or args[0] not in SOURCE or not torch.cuda.is_available():
        print(__doc__)
        return 1
    which, rest = args[0], args[1:]
    text = (_build.CSRC / f"{SOURCE[which]}.cu").read_text()
    if rest[0] == "--source" and len(rest) == 2:
        variant, edits = Path(rest[1]).read_text(), [("--source", rest[1])]
    elif len(rest) % 2 == 0:
        edits, variant = list(zip(rest[::2], rest[1::2])), text
        for old, new in edits:
            if old not in variant:
                raise SystemExit(f"{old!r} is not in the source")
            variant = variant.replace(old, new)
    else:
        print(__doc__)
        return 1
    libs = {"A": build(text, f"{SOURCE[which]}_a"), "B": build(variant, f"{SOURCE[which]}_b")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (BATCH[which], 128, 128, 8 * GROUPS)
    b, h, w, c = shape
    lo, d = cv.shift_range(MAX_SHIFT, True)
    left, right = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream
    if which == "fwd":
        for lib in libs.values():
            lib.gwc_volume.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        outs = {k: (torch.empty((b, d, h, w, GROUPS), dtype=left.dtype, device="cuda"),)
                for k in libs}
        plain = (cv.gwc_volume_norm_plain(left, right, MAX_SHIFT, GROUPS, True),)

        def call(k):
            err = libs[k].gwc_volume(left.data_ptr(), right.data_ptr(), outs[k][0].data_ptr(), b,
                                     h, w, c, GROUPS, lo, d, 1, stream)
            _build.check(err, f"gwc_volume {k}")
    else:
        for lib in libs.values():
            cv.bind_bwd(lib)
        gbar = torch.randn((b, d, h, w, GROUPS), device="cuda", generator=gen).bfloat16()
        outs = {k: (torch.empty_like(left), torch.empty_like(right)) for k in libs}
        plain = cv.gwc_volume_norm_bwd_plain(left, right, gbar, MAX_SHIFT, GROUPS, True)

        def call(k):
            err = libs[k].gwc_volume_bwd(left.data_ptr(), right.data_ptr(), gbar.data_ptr(),
                                         outs[k][0].data_ptr(), outs[k][1].data_ptr(), None, None,
                                         b, h, w, c, GROUPS, lo, d, 1, stream)
            _build.check(err, f"gwc_volume_bwd {k}")

    for k in libs:
        call(k)
    torch.cuda.synchronize()
    rel = {k: max(((o.float() - p.float()).abs().max() / p.float().abs().max()).item()
                  for o, p in zip(outs[k], plain)) for k in libs}
    if not all(r <= TOL for r in rel.values()):
        raise AssertionError(f"max relative error against the plain version {rel}")
    same = all(torch.equal(x, y) for x, y in zip(outs["A"], outs["B"]))
    buf = torch.zeros(16 << 20, dtype=torch.float32, device="cuda")
    scrubs = {"ms": buf.zero_, "ms_clean_l2": buf.sum}
    rounds = {k: {m: [] for m in scrubs} for k in libs}
    for _ in range(ROUNDS):
        for k in "ABBA":
            for m, scrub in scrubs.items():
                rounds[k][m].append(timed_ms(lambda: call(k), scrub))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    res = {k: dict(**{m: statistics.median(r) for m, r in v.items()}, rounds=v,
                   max_rel_err=rel[k], **occupancy(libs[k], SOURCE[which], (c, GROUPS, d, 1)))
           for k, v in rounds.items()}
    print(json.dumps(dict(kernel=which, shape=list(shape), edits=edits, b_equals_a=same,
                          device=torch.cuda.get_device_name(0), **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
