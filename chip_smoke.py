"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds the hand-written kernels from ``semstereo_tpu_torch/csrc`` (nvcc)
   and prints the card's name and power limit with the build time.
2. Kernels: each kernel of the main path at the shapes the main path gives
   it (K1 ``conv3d_bn_act`` at its 13 shapes, K2 ``gwc_volume`` symmetric
   and positive), bf16 and fp32, against its plain PyTorch version on the
   card (TF32 off): max abs/rel error, kernel and plain device times (median
   of CUDA-event timings, L2 scrubbed before each), the least time the card
   could take (bound), and for K1 the time of ``F.conv3d`` + affine + ReLU
   as a yardstick the port never calls.
3. Path: SemStereo US3D stage 2, eval, bf16, B=1, 1024x1024, maxdisp 64,
   seeded random weights with non-trivial BN statistics; 2 warm-up and 10
   timed requests on an integer-shift stereo pair.  Launch counts are zeroed
   just before and read just after; every request must launch K1 9 times at
   stride 1, 4 times at stride 2 and K2 once.
4. Agreement: the same weights at 256x256 against one fp32 CPU run (plain
   versions): the card in fp32 end to end, held to the bounds of
   tests/test_torch_model.py; the card in bf16, the main path's dtype, by
   its labels and by each volume module against its fp32 CPU twin on the
   inputs the bf16 run gave it (``BF16_REL``).

Prints one JSON line of per-kernel numbers, then, last, the ``ok`` line.
Exits non-zero (and prints no result) without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (dense): HBM bytes/s and FLOP/s by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Max relative error (max |kernel - plain| / max |plain|) allowed per dtype:
# bf16 outputs are rounded once from fp32 sums; fp32 differs by summation order.
REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# K1 at the main path's shapes, 1024x1024 maxdisp 64: (name, x shape, F, stride)
K1_SHAPES = [
    ("hourglass_att.conv1", (1, 16, 128, 128, 32), 64, 2),
    ("hourglass_att.conv2", (1, 8, 64, 64, 64), 64, 1),
    ("hourglass_att.conv3", (1, 8, 64, 64, 64), 128, 2),
    ("hourglass_att.conv4", (1, 4, 32, 32, 128), 128, 1),
    ("classif_att.conv0", (1, 16, 128, 128, 32), 32, 1),
    ("classif_att.conv1", (1, 16, 128, 128, 32), 1, 1),
    ("concat_stem", (1, 24, 256, 256, 64), 32, 1),
    ("hourglass.conv1", (1, 24, 256, 256, 32), 64, 2),
    ("hourglass.conv2", (1, 12, 128, 128, 64), 64, 1),
    ("hourglass.conv3", (1, 12, 128, 128, 64), 128, 2),
    ("hourglass.conv4", (1, 6, 64, 64, 128), 128, 1),
    ("classif.conv0", (1, 24, 256, 256, 32), 32, 1),
    ("classif.conv1", (1, 24, 256, 256, 32), 1, 1),
]
# K2 at the main path's shape: features [1, 128, 128, 256], 32 groups, 8 shifts
K2_SHAPE = ((1, 128, 128, 256), 32, 8)
PATH_DTYPE = torch.bfloat16
# The card in fp32 against the CPU (plain versions) at 256x256: the bounds of
# tests/test_torch_model.py, as the two runs differ only by summation order
# and top-k ties.  label_l (rtol, atol), then disparity median, p75, |bias|
# (px) and share of pixels > 1 px.
FP32_BOUNDS = dict(label=(1e-3, 2e-3), median=0.01, p75=0.1, bias=0.01, frac_gt_1px=0.08)
# The main path's volume modules (every K1 launch; K2 feeds hourglass_att).
VOLUME_MODULES = ("hourglass_att", "classif_att_", "concat_stem", "hourglass", "classif")
# The card in bf16 against fp32 on the CPU: max |card - CPU| / max |CPU| of
# label_l and of each volume module's output on the inputs the card run gave
# it.  bf16 keeps 8 significant bits and these chains round their
# activations tens of times; a fault in a kernel (a wrong tap, channel or
# mask) shows as an error of the order of the output itself.
BF16_REL = 5e-2
# ~25 ms of spinning at the H100's clock: longer than the host takes to
# enqueue one timing loop.
SPIN_CYCLES = 50_000_000


def log(*a):
    print(*a, flush=True)


def timed_ms(fn, reps: int, scrub: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each timed by its own
    CUDA events with L2 scrubbed before it.  A spin kernel keeps the device
    busy while the host enqueues the runs, so the events see the device's
    time alone and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for a, b in ev:
        scrub.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in fp32 on the CPU."""
    want = want.float().cpu()
    return ((got.float().cpu() - want).abs().max() / want.abs().max()).item()


def compare(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_k1(ops, gen, scrub):
    """Per-shape results of K1 for both dtypes."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.finfo(dtype).bits // 8
        for name, xs, f, s in K1_SHAPES:
            c = xs[-1]
            x = torch.randn(xs, device="cuda", generator=gen).to(dtype)
            w = (torch.randn((3, 3, 3, c, f), device="cuda", generator=gen)
                 * (2.0 / (27 * c)) ** 0.5).to(dtype)
            sc = torch.rand(f, device="cuda", generator=gen) + 0.5
            bi = 0.1 * torch.randn(f, device="cuda", generator=gen)
            y = ops.conv3d_bn_act(x, w, sc, bi, s, True)
            torch.cuda.synchronize()
            ref = ops.conv3d_bn_act_plain(x, w, sc, bi, s, True)
            err, rel = compare(y, ref)
            if not rel <= REL_TOL[dtype]:
                raise AssertionError(f"K1 {name} {dtype}: rel err {rel:.3e}")
            x_ncdhw = x.permute(0, 4, 1, 2, 3)  # channels_last_3d strides
            w_fcdhw = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            sc_t, bi_t = sc.to(dtype), bi.to(dtype)

            def library():
                yl = torch.nn.functional.conv3d(x_ncdhw, w_fcdhw, stride=s, padding=1)
                return torch.relu(yl.permute(0, 2, 3, 4, 1) * sc_t + bi_t)

            m = y.numel() // f
            flops = 2.0 * m * 27 * c * f
            nbytes = (x.numel() + w.numel() + y.numel()) * size + 8 * f
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            row = dict(
                kernel="K1-s1" if s == 1 else "K1-s2", name=name, dtype=str(dtype)[6:],
                shape=list(xs), F=f, stride=s, max_abs_err=err, max_rel_err=rel,
                ms=timed_ms(lambda: ops.conv3d_bn_act(x, w, sc, bi, s, True), 10, scrub),
                plain_ms=timed_ms(lambda: ops.conv3d_bn_act_plain(x, w, sc, bi, s, True), 3,
                                  scrub),
                library_ms=timed_ms(library, 10, scrub), bound_ms=b_ms, bound_by=b_by,
                gflop=flops / 1e9,
            )
            log("kernel", json.dumps(row))
            rows.append(row)
    return rows


def check_k2(ops, gen, scrub):
    rows = []
    (b, h, w, c), g, s = K2_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.finfo(dtype).bits // 8
        for symmetric in (True, False):
            left = torch.randn((b, h, w, c), device="cuda", generator=gen).to(dtype)
            right = torch.randn((b, h, w, c), device="cuda", generator=gen).to(dtype)
            y = ops.gwc_volume_norm(left, right, s, g, symmetric)
            torch.cuda.synchronize()
            ref = ops.gwc_volume_norm_plain(left, right, s, g, symmetric)
            err, rel = compare(y, ref)
            if not rel <= REL_TOL[dtype]:
                raise AssertionError(f"K2 symmetric={symmetric} {dtype}: rel err {rel:.3e}")
            d = y.shape[1]
            flops = 2.0 * d * h * w * c * b + 2.0 * 2 * b * h * w * c  # dots + norms
            nbytes = (2 * left.numel() + y.numel()) * size
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            row = dict(
                kernel="K2", name="gwc_volume " + ("symmetric" if symmetric else "positive"),
                dtype=str(dtype)[6:], shape=[b, h, w, c], G=g, D=d, max_abs_err=err,
                max_rel_err=rel,
                ms=timed_ms(lambda: ops.gwc_volume_norm(left, right, s, g, symmetric), 20, scrub),
                plain_ms=timed_ms(
                    lambda: ops.gwc_volume_norm_plain(left, right, s, g, symmetric), 5, scrub),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
            )
            log("kernel", json.dumps(row))
            rows.append(row)
    return rows


def seeded_model(cfg, seed: int):
    """fp32 CPU model: seeded init, non-trivial BN statistics and affine, and
    x8 classifier output kernels (peaked disparity posteriors)."""
    from semstereo_tpu_torch.models import build_model
    from semstereo_tpu_torch.nn import BatchNorm

    model = build_model(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.shape
                m.weight.mul_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.add_(0.05 * torch.randn(n, generator=gen))
                m.running_mean.add_(0.1 * torch.randn(n, generator=gen))
                m.running_var.mul_(0.5 + torch.rand(n, generator=gen))
        model.classif_att_[2].weight.mul_(8.0)
        model.classif[2].weight.mul_(8.0)
    return model


def stereo_pair(size: int, shift: int, seed: int):
    rng = np.random.default_rng(seed)
    right = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    left = np.roll(right, shift, axis=2)
    return torch.from_numpy(left), torch.from_numpy(right)


def counts(ops):
    return {"K1-s1": ops.conv3d_bn_act.launches_s1, "K1-s2": ops.conv3d_bn_act.launches_s2,
            "K2": ops.gwc_volume_norm.launches}


def reset_counts(ops):
    ops.conv3d_bn_act.launches_s1 = 0
    ops.conv3d_bn_act.launches_s2 = 0
    ops.gwc_volume_norm.launches = 0


def run_path(ops, cpu_model, n_warm=2, n_timed=10):
    model = copy.deepcopy(cpu_model).to("cuda", PATH_DTYPE)
    left, right = (t.to("cuda", PATH_DTYPE) for t in stereo_pair(1024, 8, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    times = []
    out = None
    for i in range(n_warm + n_timed):
        t0 = time.perf_counter()
        out = model(left, right)
        torch.cuda.synchronize()
        if i >= n_warm:
            times.append(1e3 * (time.perf_counter() - t0))
    launches = counts(ops)
    n = n_warm + n_timed
    want = {"K1-s1": 9 * n, "K1-s2": 4 * n, "K2": n}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} for {n} requests")
    disp, label = out["disp"][0], out["label_l"]
    if tuple(disp.shape) != (1, 1024, 1024) or tuple(label.shape) != (1, 1024, 1024, 6):
        raise AssertionError(f"shapes disp {tuple(disp.shape)} label {tuple(label.shape)}")
    if not (torch.isfinite(disp).all() and torch.isfinite(label).all()):
        raise AssertionError("non-finite outputs")
    mean_ms = statistics.mean(times)
    res = dict(requests=n, timed=n_timed, ms_per_pair_mean=mean_ms,
               ms_per_pair_median=statistics.median(times), ms_min=min(times),
               ms_max=max(times), pairs_per_s=1e3 / mean_ms,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, launches_per_request={k: v // n for k, v in launches.items()},
               disp_mean=disp.float().mean().item())
    log("path", json.dumps(res))
    return res


def disp_stats(got, ref):
    """Disparity differences on columns >= 32, as tests/test_torch_model.py
    takes them: median, p75, mean signed difference of the bulk (< 0.5 px)
    and share of pixels more than 1 px off."""
    signed = got[:, :, 32:].double() - ref[:, :, 32:].double()
    diff = signed.abs()
    bulk = diff < 0.5
    return dict(median=diff.median().item(), p75=diff.quantile(0.75).item(),
                bias=signed[bulk].mean().item(), frac_gt_1px=(diff > 1).double().mean().item())


def card_run(ops, cpu_model, dtype, left, right, capture=()):
    """One request at 256x256 on the card; records the (inputs, output) of
    each module named in ``capture``."""
    model = copy.deepcopy(cpu_model).to("cuda", dtype)
    seen = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, (args, out))) for n in capture]
    reset_counts(ops)
    out = model(left.to("cuda", dtype), right.to("cuda", dtype))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if counts(ops) != {"K1-s1": 9, "K1-s2": 4, "K2": 1}:
        raise AssertionError(f"{dtype} card run launches {counts(ops)}")
    return out, seen


def run_agreement(ops, cpu_model):
    """The same weights at 256x256 against the CPU in fp32 (plain versions):
    the card in fp32 end to end; the card in bf16, the main path's dtype,
    module by module.  An untrained net's disparity does not survive bf16
    rounding (its top-k plane choice flips), so the bf16 disparity is only
    checked for finite values and its differences are printed."""
    left, right = stereo_pair(256, 5, seed=1)
    cpu = cpu_model(left, right)
    bounds = FP32_BOUNDS
    card, _ = card_run(ops, cpu_model, torch.float32, left, right)
    label = card["label_l"].cpu()
    label_ok = torch.allclose(label, cpu["label_l"], *bounds["label"])
    stats = disp_stats(card["disp"][0].cpu(), cpu["disp"][0])
    log("agreement", json.dumps(dict(size=256, dtype="float32",
                                     label_max_abs=(label - cpu["label_l"]).abs().max().item(),
                                     **stats)))
    if not (label_ok and stats["median"] < bounds["median"] and stats["p75"] < bounds["p75"]
            and abs(stats["bias"]) < bounds["bias"]
            and stats["frac_gt_1px"] < bounds["frac_gt_1px"]):
        raise AssertionError("card (fp32) and CPU runs disagree")

    card, seen = card_run(ops, cpu_model, torch.bfloat16, left, right, VOLUME_MODULES)
    rel = {"label_l": max_rel(card["label_l"], cpu["label_l"])}
    with torch.inference_mode():
        for name in VOLUME_MODULES:
            args, got = seen[name]
            rel[name] = max_rel(got, getattr(cpu_model, name)(*(a.float().cpu() for a in args)))
    disp = card["disp"][0].float().cpu()
    finite = bool(torch.isfinite(disp).all())
    log("agreement", json.dumps(dict(size=256, dtype="bfloat16", max_rel=rel, disp_finite=finite,
                                     disp=disp_stats(disp, cpu["disp"][0]))))
    if not (finite and max(rel.values()) <= BF16_REL):
        raise AssertionError("card (bf16) and CPU runs disagree")


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: the port's kernels and main path run on the card")
        return 1
    from semstereo_tpu_torch import ops
    from semstereo_tpu_torch.config import PRESETS
    from semstereo_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build_s = _build.build_all()
    log(smi)
    log(f"build {build_s:.1f} s; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = check_k1(ops, gen, scrub) + check_k2(ops, gen, scrub)
    del scrub

    cpu_model = seeded_model(PRESETS["us3d_stage2"], seed=0)
    path = run_path(ops, cpu_model)
    run_agreement(ops, cpu_model)

    kernels = []
    meta = {
        "K1-s1": ("semstereo_tpu_torch/csrc/conv3d.cu",
                  "semstereo_tpu/ops/pallas/conv3d_wl.py:236"),
        "K1-s2": ("semstereo_tpu_torch/csrc/conv3d.cu",
                  "semstereo_tpu/ops/pallas/conv3d_wl.py:276"),
        "K2": ("semstereo_tpu_torch/csrc/gwc_volume.cu",
               "semstereo_tpu/ops/pallas/cost_volume_kernel.py:150"),
    }
    for name, (source, replaces) in meta.items():
        # one request's worth: every main-path shape of the kernel, path dtype
        mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"]
        if name == "K2":
            mine = [r for r in mine if r["name"].endswith("symmetric")]
        lib = [r["library_ms"] for r in mine]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path["launches"][name],
            launches_per_request=path["launches_per_request"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in mine), plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            bound_by=max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in mine if r["bound_by"] == by)),
            library_ms=None if None in lib else sum(lib),
        ))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
