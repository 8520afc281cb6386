"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds the hand-written kernels from ``semstereo_tpu_torch/csrc`` (nvcc)
   and prints the card's name and power limit with the build time.
2. Kernels: each kernel of the main path at the shapes the main path gives
   it (K1 ``conv3d_bn_act`` at its 13 shapes, K2 ``gwc_volume`` symmetric
   and positive at B = 1 and, as the train step gives it, B = 2), bf16 and
   fp32, against its plain PyTorch version on the
   card (TF32 off): max abs/rel error, kernel and plain device times (median
   of CUDA-event timings, L2 scrubbed before each), the least time the card
   could take (bound), and for K1 the time of ``F.conv3d`` + affine + ReLU
   as a yardstick the port never calls.  K1 also runs, in bf16, at the
   shapes of the stride-1 dx that K3 gives it at the train batch (C and F
   swapped, C = 1 for the Cout=1 convs), in rows marked ``role: "dx"``.
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
5. Train kernels: K3, the backward of ``ops.conv3d.conv3d`` (stride-1 dx
   by K1, stride-2 dx by ``F.conv_transpose3d``, dw by the kernel of
   ``csrc/conv3d_wgrad.cu``), at the 13 volume-conv shapes at the train
   batch, and K4 ``gwc_volume_bwd`` at the main-path shape, symmetric and
   positive, bf16 and fp32, and at plane counts that take a launch per
   slab of planes (D = 20 fp32, D = 36 bf16), against their plain versions
   (K3's dw also alone against ``conv3d_weight_grad_plain``; K4 also against
   autograd of the plain forward, with its resident blocks per SM and shared
   memory per block): errors, device times of each part, bound, and as
   yardsticks the port never calls, cuDNN's whole backward (autograd of
   ``F.conv3d``), its dgrad alone and its wgrad alone
   (``torch.nn.grad.conv3d_input`` / ``conv3d_weight``).
6. Train path: one US3D stage-2 train step at 1024x1024, batch 2, bf16
   compute on fp32 master parameters, Adam lr 1e-3, seg + LRSC losses,
   through ``train.init_state`` and ``train.make_train_step``, on one
   seeded synthetic batch: 2 warm-up and 5 timed steps with the launch
   counts of ``TRAIN_LAUNCHES`` per step, finite losses and gradients, and
   parameters that moved.
7. Train agreement: one fp32 step at 256x256 on the card against the same
   step on the CPU (plain versions) from the same weights and batch: the
   loss terms, the BN running statistics after the step and every gradient
   (``TRAIN_BOUNDS``).
8. Trainer: the paper's two-stage recipe through the port's command lines
   (``cli.train.main``, ``cli.evaluate.main``) on a US3D-format file
   dataset written at full width into a temporary directory (1024x1024 PNG
   views, float-TIFF disparity in the symmetric range, PNG labels; 4 train
   and 3 test rows), bf16, batch 2, 4 loader threads: stage 1 for an epoch
   (2 steps, a checkpoint, an eval epoch ending in a ragged batch of 1);
   stage 2 warm-started from it (the printed count of partially loaded
   tensors must be the one ``restore_partial`` gives on the CPU, where a
   stage-2-only leaf keeps its own value); a resumed second epoch of stage
   2 (it must start at epoch 1, with a finite loss); then the evaluate
   command with ``--save-dir`` (3 uint16 1024x1024 ``<stem>_disp.png``).
   Every train step of stage 2 must launch ``TRAIN_LAUNCHES`` and every
   eval batch ``EVAL_LAUNCHES``; stage 1 must launch every kernel.  Prints
   the median ms per step of each stage, each epoch's host and loader time
   (its wall time less its steps'), the eval epoch's time, peak memory,
   the host's time for one train sample and the native sample prep's
   status.
9. fuse_views (after the eval agreement): the eval path's request with the
   views stacked through the front end and in two passes, 10 of each
   interleaved: ``EVAL_LAUNCHES`` per request, the labels and the fused
   front-end modules' outputs within ``BF16_REL`` of each other (the bf16
   disparity finite, its differences printed); then one request of each in
   fp32 with every /4 plane kept, whose disparities must agree
   (``FUSE_FP32_BOUNDS``); ms per pair,
   and from one profiled request of each the total kernel launches and
   device time.
10. remat (after the train path): the train path's step with
   ``remat="full"`` and ``remat="featup"`` through ``init_state`` and
   ``make_train_step``, 1 warm-up and 3 timed steps each: ms per step and
   peak memory beside the train path's, launches per step
   (``REMAT_LAUNCHES``); then, from the train agreement's state and 256x256
   batch, each remat step's loss terms, BN statistics and gradients against
   the plain step's (``TRAIN_BOUNDS``), in fp32; in bf16 the loss terms and
   statistics, with the gradients' differences printed beside a second
   plain step's.
11. data parallel (after the trainer): (a) two processes on the one card,
   gloo on CUDA tensors (NCCL refuses two ranks on one device), each
   running the fp32 256x256 step of the train agreement on its row of the
   global batch of 2, against the one-process batch-2 step from the same
   weights (loss terms, BN statistics and every gradient, ``TRAIN_BOUNDS``;
   launches ``TRAIN_LAUNCHES`` per process); (b) ``cli.train`` as
   ``torchrun`` starts it, NCCL over ``torch.cuda.device_count()``
   processes, one stage-2 epoch of the trainer's dataset with
   ``--data-parallel -1 --remat featup --pretrained-backbone`` (a
   timm-named state_dict of the test oracle's backbone, written here): the
   printed count of loaded tensors must be the one the CPU gives, and every
   step and eval batch must launch ``TRAIN_LAUNCHES`` and
   ``EVAL_LAUNCHES``.  The processes are this script run as
   ``chip_smoke.py --worker dp-step|dp-cli ...``.

Prints one JSON line of per-kernel numbers, then, last, the ``ok`` line.
Exits non-zero (and prints no result) without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
# The train path: batch per card, warm-up and timed steps, and the kernel
# launches of one step (forward: 9 + 4 volume convs and the cost volume;
# backward: a K1 dx for each stride-1 conv ("K3"), a dw for each of the 13
# volume convs ("K3-dw"), K4 once).
TRAIN_BATCH = 2
TRAIN_WARM, TRAIN_TIMED = 2, 5
TRAIN_LAUNCHES = {"K1-s1": 18, "K1-s2": 4, "K2": 1, "K3": 9, "K3-dw": 13, "K4": 1}
EVAL_LAUNCHES = {"K1-s1": 9, "K1-s2": 4, "K2": 1, "K3": 0, "K3-dw": 0, "K4": 0}
# The trainer phase: train and test rows of its file dataset, loader threads.
TRAINER_ROWS = (4, 3)
TRAINER_WORKERS = 4
# The remat phase: the JAX package's two named uses ("full": the backbone
# and both hourglasses; "featup": the FPN alone), warm-up and timed
# steps.  Per step, each hourglass recomputes its 2 stride-1 and 2 stride-2
# K1 convs in the backward; the rest (K1 as K3's dx, dw, K2, K4) runs once.
REMAT_SPECS = ("full", "featup")
REMAT_WARM, REMAT_TIMED = 1, 3
REMAT_LAUNCHES = {"full": dict(TRAIN_LAUNCHES, **{"K1-s1": 22, "K1-s2": 8}),
                  "featup": TRAIN_LAUNCHES}
# The fuse_views phase: requests of each front end, interleaved, and the
# modules that run on the stacked views when fused.
FUSE_REQUESTS = 10
FUSE_MODULES = ("feature_up", "chal_1", "chal_2", "concat_feature")
# The fp32 fused request's disparity against the two-pass one's (TF32 off),
# in px.  Every /4 plane is kept by both top-k stages (topk = refine_topk =
# the plane count), so the forward has no hard choice: at the eval path's
# top-24 the stacked batch's cuDNN and cuBLAS calls, which round otherwise
# than batch 1's, flip near-ties (5.3 % of pixels more than 1e-3 px off,
# max 26.6 px; H100, PR 8 call 9).  With every plane kept that rounding
# leaves median 1.1e-4 px and max 0.014 px (call 10), the level of the fp32
# card against the CPU in the eval agreement (median 1.2e-4 px); a fault
# in how the fused path splits the views moves pixels by whole pixels.
# tests/test_torch_fuse_views.py holds the CPU, whose convs give each view
# the same arithmetic at batch 1 and 2, to median 1e-5 px and max 1e-3 px.
FUSE_FP32_BOUNDS = dict(median=1e-3, max=0.1)
# The data-parallel phase's processes: seconds each may take.
DP_TIMEOUT = 600
# K4 at the main path's shape at the train batch: features [2, 128, 128, 256].
K4_SHAPE = ((TRAIN_BATCH, 128, 128, 256), 32, 8)
# K4 at symmetric plane counts above one launch's slab, the smallest that
# one launch could not hold before (D = 20 fp32, D = 36 bf16): (dtype,
# max_shift).
K4_LARGE_D = [(torch.float32, 10), (torch.bfloat16, 18)]
# The fp32 card step against the CPU step at 256x256 with every plane kept
# by the top-k stages (topk = refine_topk = 32, the /4 plane count), so no
# hard choice sits on the gradient's path: loss terms (relative), running
# statistics (absolute), and ||card - CPU|| / ||CPU|| of the gradients per
# top-level module and per leaf (leaves with a non-zero gradient).  Both
# sides are fp32 and differ by summation order, which the untrained net
# amplifies on the way to its gradient; a fault in a backward (a wrong tap,
# flip, channel swap or mask) gives an error of the order of the gradient
# itself.
TRAIN_BOUNDS = dict(loss=1e-4, stats=1e-3, grad_module=0.05, grad_leaf=0.05)
# ~25 ms of spinning at the H100's clock: longer than the host takes to
# enqueue one timing loop.
SPIN_CYCLES = 50_000_000


def log(*a):
    print(*a, flush=True)


def phase(name: str, since: float) -> float:
    """Logs the wall time of a phase that began at ``since``; returns now."""
    now = time.perf_counter()
    log(f"phase {name} {now - since:.1f} s")
    return now


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


def k1_dx_shapes():
    """K1 as K3's stride-1 dx: the output gradient of each stride-1 conv at
    the train batch as input, the conv's C as output channels."""
    return [(name + " dx", (TRAIN_BATCH, *xs[1:4], f), xs[-1], 1)
            for name, xs, f, s in K1_SHAPES if s == 1]


def check_k1(ops, gen, scrub):
    """Per-shape results of K1 for both dtypes, and at the dx shapes in bf16."""
    rows = []
    runs = [(torch.bfloat16, K1_SHAPES, "forward"), (torch.float32, K1_SHAPES, "forward"),
            (torch.bfloat16, k1_dx_shapes(), "dx")]
    for dtype, shapes, role in runs:
        size = torch.finfo(dtype).bits // 8
        for name, xs, f, s in shapes:
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
                kernel="K1-s1" if s == 1 else "K1-s2", name=name, role=role,
                dtype=str(dtype)[6:], shape=list(xs), F=f, stride=s, max_abs_err=err,
                max_rel_err=rel,
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
    """K2 at the eval path's shape (B = 1) and the train step's (B = 2), with
    its resident blocks per SM and dynamic shared memory per block."""
    from semstereo_tpu_torch.ops.cost_volume import gwc_volume_occupancy

    rows = []
    (_, h, w, c), g, s = K2_SHAPE
    for b in (1, TRAIN_BATCH):
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
                    raise AssertionError(f"K2 B={b} symmetric={symmetric} {dtype}: rel err "
                                         f"{rel:.3e}")
                d = y.shape[1]
                flops = 2.0 * d * h * w * c * b + 2.0 * 2 * b * h * w * c  # dots + norms
                nbytes = (2 * left.numel() + y.numel()) * size
                b_ms, b_by = bound_ms(nbytes, flops, dtype)
                blocks, smem = gwc_volume_occupancy(c, g, d, dtype)
                row = dict(
                    kernel="K2", name="gwc_volume " + ("symmetric" if symmetric else "positive"),
                    role="forward" if b == 1 else "train_batch",
                    dtype=str(dtype)[6:], shape=[b, h, w, c], G=g, D=d, blocks_per_sm=blocks,
                    smem_bytes=smem, max_abs_err=err, max_rel_err=rel,
                    ms=timed_ms(lambda: ops.gwc_volume_norm(left, right, s, g, symmetric), 20,
                                scrub),
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
    from semstereo_tpu_torch.ops.conv3d import conv3d_input_grad_s1, conv3d_weight_grad

    return {"K1-s1": ops.conv3d_bn_act.launches_s1, "K1-s2": ops.conv3d_bn_act.launches_s2,
            "K2": ops.gwc_volume_norm.launches, "K3": conv3d_input_grad_s1.launches,
            "K3-dw": conv3d_weight_grad.launches, "K4": ops.gwc_volume_norm_bwd.launches}


def reset_counts(ops):
    from semstereo_tpu_torch.ops.conv3d import conv3d_input_grad_s1, conv3d_weight_grad

    ops.conv3d_bn_act.launches_s1 = 0
    ops.conv3d_bn_act.launches_s2 = 0
    ops.gwc_volume_norm.launches = 0
    conv3d_input_grad_s1.launches = 0
    conv3d_weight_grad.launches = 0
    ops.gwc_volume_norm_bwd.launches = 0


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
    want = {k: v * n for k, v in EVAL_LAUNCHES.items()}
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
    if counts(ops) != EVAL_LAUNCHES:
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


def check_k3(gen, scrub):
    """K3, the backward of ``conv3d``, at the 13 volume-conv shapes at the
    train batch, both dtypes: y, dx and dw against ``conv3d_plain`` (fp32
    ``F.conv3d`` and autograd), dw alone against ``conv3d_weight_grad_plain``,
    and the device time of each part beside cuDNN's."""
    from semstereo_tpu_torch.ops import conv3d as c3

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.finfo(dtype).bits // 8
        for name, xs, f, s in K1_SHAPES:
            xs = (TRAIN_BATCH, *xs[1:])
            c = xs[-1]
            x = torch.randn(xs, device="cuda", generator=gen).to(dtype).requires_grad_()
            w = (torch.randn((f, c, 3, 3, 3), device="cuda", generator=gen)
                 * (2.0 / (27 * c)) ** 0.5).to(dtype).requires_grad_()
            y = c3.conv3d(x, w, s)
            gy = torch.randn(y.shape, device="cuda", generator=gen).to(dtype)
            dx, dw = torch.autograd.grad(y, (x, w), gy)
            torch.cuda.synchronize()
            y_p = c3.conv3d_plain(x, w, s)
            dx_p, dw_p = torch.autograd.grad(y_p, (x, w), gy, retain_graph=True)
            xd, wd = x.detach(), w.detach()
            dw_k = c3.conv3d_weight_grad(xd, gy, s)
            torch.cuda.synchronize()
            dw_plain = c3.conv3d_weight_grad_plain(xd.float(), gy.float(), s)
            errs = {k: compare(a, b) for k, (a, b) in
                    dict(y=(y, y_p), dx=(dx, dx_p), dw=(dw, dw_p),
                         dw_alone=(dw_k, dw_plain)).items()}
            if not all(rel <= REL_TOL[dtype] for _, rel in errs.values()):
                raise AssertionError(f"K3 {name} {dtype}: {errs}")
            w3 = wd.permute(2, 3, 4, 1, 0).contiguous()
            if s == 1:
                dx_ms = timed_ms(lambda: c3.conv3d_input_grad_s1(gy, w3), 10, scrub)
                s2_ms = 0.0
            else:
                dx_ms = 0.0
                s2_ms = timed_ms(lambda: c3.conv3d_input_grad_s2(gy, wd, xs[1:4]), 10, scrub)
            dw_ms = timed_ms(lambda: c3.conv3d_weight_grad(xd, gy, s), 5, scrub)
            plain_ms = timed_ms(
                lambda: torch.autograd.grad(y_p, (x, w), gy, retain_graph=True), 3, scrub)
            # cuDNN's backward in the working dtype on channels_last_3d tensors
            x_l = xd.permute(0, 4, 1, 2, 3).detach().requires_grad_()
            w_l = wd.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
            y_l = torch.nn.functional.conv3d(x_l, w_l, stride=s, padding=1)
            gy_l = gy.permute(0, 4, 1, 2, 3)
            library_ms = timed_ms(
                lambda: torch.autograd.grad(y_l, (x_l, w_l), gy_l, retain_graph=True), 10, scrub)
            # cuDNN's dgrad and wgrad alone, in the path dtype only (the
            # kernels line reads bf16 rows)
            xl_d, wl_d = x_l.detach(), w_l.detach()
            dx_library_ms = dw_library_ms = None
            if dtype == PATH_DTYPE:
                dx_library_ms = timed_ms(lambda: torch.nn.grad.conv3d_input(
                    xl_d.shape, wl_d, gy_l, stride=s, padding=1), 10, scrub)
                dw_library_ms = timed_ms(lambda: torch.nn.grad.conv3d_weight(
                    xl_d, wl_d.shape, gy_l, stride=s, padding=1), 10, scrub)
            m = y.numel() // f
            flops = 2 * 2.0 * m * 27 * c * f  # dx and dw
            nbytes = (2 * x.numel() + 2 * w.numel() + gy.numel()) * size
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            row = dict(
                kernel="K3", name=name, dtype=str(dtype)[6:], shape=list(xs), F=f, stride=s,
                max_abs_err=max(e for e, _ in errs.values()),
                max_rel_err={k: r for k, (_, r) in errs.items()},
                ms=dx_ms + s2_ms + dw_ms, dx_k1_ms=dx_ms, s2_dx_ms=s2_ms, dw_ms=dw_ms,
                plain_ms=plain_ms, library_ms=library_ms, dx_library_ms=dx_library_ms,
                dw_library_ms=dw_library_ms, bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9,
            )
            log("kernel", json.dumps(row))
            rows.append(row)
            del x, w, y, gy, dx, dw, y_p, dx_p, dw_p, x_l, w_l, y_l, dw_k, dw_plain
    return rows


def check_k4(ops, gen, scrub):
    """K4 at the main path's shape: against the plain closed form and
    against autograd of the plain forward; with its resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and dynamic shared
    memory per block.  Then at ``K4_LARGE_D``, plane counts that take more
    than one launch (``role: "large_d"``)."""
    from semstereo_tpu_torch.ops.cost_volume import gwc_volume_bwd_occupancy

    rows = []
    (b, h, w, c), g, s = K4_SHAPE
    runs = [(dtype, s, symmetric, "forward") for dtype in (torch.bfloat16, torch.float32)
            for symmetric in (True, False)]
    runs += [(dtype, shift, True, "large_d") for dtype, shift in K4_LARGE_D]
    for dtype, s, symmetric, role in runs:
        size = torch.finfo(dtype).bits // 8
        d = 2 * s if symmetric else s
        left = torch.randn((b, h, w, c), device="cuda", generator=gen).to(dtype)
        right = torch.randn((b, h, w, c), device="cuda", generator=gen).to(dtype)
        gbar = torch.randn((b, d, h, w, g), device="cuda", generator=gen).to(dtype)
        before = ops.gwc_volume_norm_bwd.launches
        got = ops.gwc_volume_norm_bwd(left, right, gbar, s, g, symmetric)
        torch.cuda.synchronize()
        launches = ops.gwc_volume_norm_bwd.launches - before
        plain = ops.gwc_volume_norm_bwd_plain(left, right, gbar, s, g, symmetric)
        lt, rt = left.clone().requires_grad_(), right.clone().requires_grad_()
        auto = torch.autograd.grad(ops.gwc_volume_norm_plain(lt, rt, s, g, symmetric),
                                   (lt, rt), gbar)
        errs = [compare(a, p_) for a, p_ in zip(got, plain)]
        errs_auto = [compare(a, p_) for a, p_ in zip(got, auto)]
        if not all(rel <= REL_TOL[dtype] for _, rel in errs + errs_auto):
            raise AssertionError(f"K4 D={d} symmetric={symmetric} {dtype}: {errs} {errs_auto}")
        flops = 2 * 2.0 * d * b * h * w * c + 8.0 * 2 * b * h * w * c  # yl, yr; norm VJPs
        nbytes = (4 * left.numel() + gbar.numel()) * size
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        blocks, smem = gwc_volume_bwd_occupancy(c, g, d, dtype)
        row = dict(
            kernel="K4", name="gwc_volume_bwd " + ("symmetric" if symmetric else "positive"),
            role=role, dtype=str(dtype)[6:], shape=[b, h, w, c], G=g, D=d,
            launches_per_call=launches,
            blocks_per_sm=blocks, smem_bytes=smem,
            max_abs_err=max(e for e, _ in errs), max_rel_err=max(r for _, r in errs),
            max_rel_err_autograd=max(r for _, r in errs_auto),
            ms=timed_ms(lambda: ops.gwc_volume_norm_bwd(left, right, gbar, s, g, symmetric),
                        20, scrub),
            plain_ms=timed_ms(lambda: ops.gwc_volume_norm_bwd_plain(
                left, right, gbar, s, g, symmetric), 5, scrub),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
        )
        log("kernel", json.dumps(row))
        rows.append(row)
        del left, right, gbar, got, plain, lt, rt, auto
    return rows


def run_train(ops):
    """The train path at 1024x1024 through the port's entry points."""
    from semstereo_tpu_torch.config import TRAIN_PRESETS
    from semstereo_tpu_torch.data import SyntheticStereoDataset
    from semstereo_tpu_torch.train import init_state, make_train_step

    cfg = TRAIN_PRESETS["us3d_stage2"].replace(compute_dtype="bfloat16")
    state = init_state(cfg)
    start = [p.detach().clone() for p in state.model.parameters()]
    batch = SyntheticStereoDataset(TRAIN_BATCH, 1024, 1024, cfg.model.maxdisp).batch(
        0, TRAIN_BATCH, "cuda")
    train_step = make_train_step(cfg)
    n = TRAIN_WARM + TRAIN_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    times, scalars = [], []
    for i in range(n):
        t0 = time.perf_counter()
        out = train_step(state, batch)
        torch.cuda.synchronize()
        if i >= TRAIN_WARM:
            times.append(1e3 * (time.perf_counter() - t0))
        scalars.append({k: v.item() for k, v in out.items()})
    launches = counts(ops)
    want = {k: v * n for k, v in TRAIN_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want} for {n} steps")
    params = list(state.model.parameters())
    if not all(np.isfinite(v) for sc in scalars for v in sc.values()):
        raise AssertionError(f"non-finite train scalars {scalars}")
    if not all(torch.isfinite(p.grad).all() for p in params):
        raise AssertionError("non-finite gradients")
    moved = sum(not torch.equal(p.detach(), p0) for p, p0 in zip(params, start))
    if moved < len(params) // 2:
        raise AssertionError(f"only {moved} of {len(params)} parameter tensors moved")
    mean_ms = statistics.mean(times)
    res = dict(size=1024, batch=TRAIN_BATCH, dtype="bfloat16", steps=n, timed=TRAIN_TIMED,
               ms_per_step_median=statistics.median(times), ms_per_step_mean=mean_ms,
               ms_min=min(times), ms_max=max(times), pairs_per_s=1e3 * TRAIN_BATCH / mean_ms,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, launches_per_step={k: v // n for k, v in launches.items()},
               params_moved=moved, params=len(params),
               loss=[sc["loss"] for sc in scalars], epe=[sc["EPE"] for sc in scalars])
    log("train", json.dumps(res))
    return res


def step_record(aux, model) -> dict:
    """The loss terms, BN running statistics and gradients of a step, on
    the CPU."""
    return dict(loss={k: float(v) for k, v in aux.items()},
                stats={n: b.detach().cpu() for n, b in model.named_buffers()},
                grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def step_agreement(got: dict, want: dict) -> tuple[dict, bool]:
    """``got`` against ``want`` (``step_record``s of one step from the same
    weights and batch) under ``TRAIN_BOUNDS``: relative difference of each
    loss term, largest absolute difference of the running statistics,
    ||got - want|| / ||want|| of the gradients per top-level module and per
    leaf (leaves with a gradient of rounding size left out).  Returns (the
    differences, whether they are within the bounds)."""
    loss_rel = {k: abs(got["loss"][k] - v) / abs(v) for k, v in want["loss"].items()
                if k in ("disp_loss", "label_loss", "lrsc_loss", "loss")}
    stats = {n: (got["stats"][n] - c).abs().max().item() for n, c in want["stats"].items()}
    pairs = [(n, got["grads"][n].double(), q.double()) for n, q in want["grads"].items()]
    total = sum(float(q.square().sum()) for _, _, q in pairs) ** 0.5
    err, norm, leaf = {}, {}, {}
    for n, p, q in pairs:
        qn = float(q.norm())
        if qn <= 1e-6 * total:  # a zero gradient (bias before a BN): rounding noise
            continue
        leaf[n] = float((p - q).norm()) / qn
        m = n.split(".")[0]
        err[m] = err.get(m, 0.0) + float((p - q).square().sum())
        norm[m] = norm.get(m, 0.0) + qn * qn
    module = {m: (err[m] / norm[m]) ** 0.5 for m in norm}
    worst_leaf = max(leaf, key=leaf.get)
    res = dict(loss_rel=loss_rel, stats_max_abs=max(stats.values()),
               stats_worst=max(stats, key=stats.get), grad_module_rel=module,
               grad_leaf_rel_max=leaf[worst_leaf], grad_leaf_worst=worst_leaf,
               grad_leaf_rel_median=statistics.median(leaf.values()), leaves=len(leaf))
    b = TRAIN_BOUNDS
    ok = (max(loss_rel.values()) <= b["loss"] and max(stats.values()) <= b["stats"]
          and max(module.values()) <= b["grad_module"] and leaf[worst_leaf] <= b["grad_leaf"])
    return res, ok


def run_train_agreement(ops):
    """One fp32 train step at 256x256 on the card against the same step on
    the CPU, from the same weights and batch (see ``TRAIN_BOUNDS``)."""
    from semstereo_tpu_torch.models import build_model
    from semstereo_tpu_torch.train import make_grads_fn

    cfg = agreement_cfg()
    cpu_model = build_model(cfg.model, device="cpu", seed=2).train()
    card_model = copy.deepcopy(cpu_model).to("cuda")
    batch = agreement_batch()
    grads_fn = make_grads_fn(cfg)
    reset_counts(ops)
    aux_card, _, _ = grads_fn(card_model, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = counts(ops)
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"fp32 card train step launches {launches}")
    aux_cpu, _, _ = grads_fn(cpu_model, batch)
    res, ok = step_agreement(step_record(aux_card, card_model), step_record(aux_cpu, cpu_model))
    log("train_agreement", json.dumps(dict(size=256, dtype="float32", launches=launches,
                                           **res)))
    if not ok:
        raise AssertionError("the fp32 card train step and the CPU step disagree")


def agreement_cfg():
    """The fp32 config of the agreement steps: every /4 plane kept by the
    top-k stages (topk = refine_topk = 32), so no hard choice sits on the
    gradient's path."""
    from semstereo_tpu_torch.config import ModelConfig, TrainConfig

    return TrainConfig(model=ModelConfig(maxdisp=64, topk=32, refine_topk=32))


def agreement_batch() -> dict:
    """The agreement steps' batch: 2 seeded synthetic 256x256 rows on the CPU."""
    from semstereo_tpu_torch.data import SyntheticStereoDataset

    return SyntheticStereoDataset(2, 256, 256, 64).batch(0, 2)


def write_us3d(root: str, n_rows: int, size: int, seed: int) -> list[str]:
    """A US3D-format list: integer-shift PNG pairs, float-TIFF disparity in
    the symmetric range, PNG labels constant on 64x64 blocks."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rows):
        right = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        d = int(rng.integers(-24, 25))
        Image.fromarray(np.roll(right, d, axis=1)).save(f"{root}/l{i}.png")
        Image.fromarray(right).save(f"{root}/r{i}.png")
        disp = (d + rng.uniform(-0.25, 0.25, (size, size))).astype(np.float32)
        Image.fromarray(disp, mode="F").save(f"{root}/d{i}.tif")
        blocks = rng.integers(0, 6, (size // 64, size // 64)).astype(np.uint8)
        Image.fromarray(np.kron(blocks, np.ones((64, 64), np.uint8))).save(f"{root}/s{i}.png")
        rows.append(f"l{i}.png r{i}.png d{i}.tif s{i}.png")
    return rows


def write_dataset(root: str) -> list[str]:
    """The trainer phases' US3D-format file dataset at 1024x1024 in ``root``:
    ``train.txt`` and ``test.txt`` lists of ``TRAINER_ROWS`` rows."""
    os.makedirs(root)
    t0 = time.perf_counter()
    rows = write_us3d(root, TRAINER_ROWS[0] + TRAINER_ROWS[1], 1024, seed=3)
    for name, part in (("train", rows[:TRAINER_ROWS[0]]), ("test", rows[TRAINER_ROWS[0]:])):
        with open(f"{root}/{name}.txt", "w") as f:
            f.write("\n".join(part) + "\n")
    log(f"trainer: dataset written in {time.perf_counter() - t0:.1f} s")
    return rows


@contextlib.contextmanager
def instrumented_steps(ops, steps: list):
    """Within the block, the trainer's steps append (kind, ms, launches) to
    ``steps``: each timed from a synchronized device to a synchronized
    device, with the kernel launches it made."""
    from semstereo_tpu_torch.train import trainer as trainer_mod

    def instrumented(kind, make):
        def factory(cfg):
            step = make(cfg)

            def run(state, batch):
                torch.cuda.synchronize()
                before, t0 = counts(ops), time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                after = counts(ops)
                steps.append((kind, 1e3 * (time.perf_counter() - t0),
                              {k: after[k] - before[k] for k in after}))
                return out
            return run
        return factory

    makers = trainer_mod.make_train_step, trainer_mod.make_eval_step
    trainer_mod.make_train_step = instrumented("train", makers[0])
    trainer_mod.make_eval_step = instrumented("eval", makers[1])
    try:
        yield steps
    finally:
        trainer_mod.make_train_step, trainer_mod.make_eval_step = makers


def run_trainer(ops, tmp: str, rows: list[str]):
    """The two-stage recipe through the command lines (docstring, item 8)
    on the dataset in ``tmp/data``.  Each step the trainer takes is timed
    from a synchronized device to a synchronized device, with the launches
    it made."""
    from semstereo_tpu_torch.cli import evaluate as cli_evaluate
    from semstereo_tpu_torch.cli import train as cli_train
    from semstereo_tpu_torch.config import TRAIN_PRESETS
    from semstereo_tpu_torch.data import Us3dDataset, native
    from semstereo_tpu_torch.train import checkpoint as ckpt
    from semstereo_tpu_torch.train import init_state

    steps = []  # (kind, ms, launches) of every step in call order
    with instrumented_steps(ops, steps):
        root, run1, run2, dump = (f"{tmp}/{d}" for d in ("data", "stage1", "stage2", "dump"))
        # the host's cost of one train sample (decode, normalize, gt
        # pyramid), one thread; the first call builds the native prep
        ds = Us3dDataset(root, f"{root}/train.txt", True)
        sample_ms = []
        for i in range(TRAINER_ROWS[0]):
            t = time.perf_counter()
            ds.get(i, np.random.default_rng(i))
            sample_ms.append(1e3 * (time.perf_counter() - t))
        common = ["--datapath", root, "--trainlist", f"{root}/train.txt", "--testlist",
                  f"{root}/test.txt", "--compute-dtype", "bfloat16", "--batch-size",
                  str(TRAIN_BATCH), "--test-batch-size", str(TRAIN_BATCH), "--save-freq", "1",
                  "--num-workers", str(TRAINER_WORKERS), "--device", "cuda"]
        res = {"sample_ms": sample_ms}

        def stage(name, argv, logdir):
            """One command line run with the counts zeroed just before
            and read just after; returns (trainer, its new log text, its
            steps)."""
            logfile = f"{logdir}/log.log"
            seen = os.path.getsize(logfile) if os.path.exists(logfile) else 0
            first = len(steps)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ops)
            t = time.perf_counter()
            out = cli_train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = counts(ops)
            with open(logfile) as f:
                f.seek(seen)
                text = f.read()
            mine = steps[first:]
            train_ms = [ms for kind, ms, _ in mine if kind == "train"]
            res[name] = dict(
                wall_s=wall, launches=launches, train_steps=len(train_ms),
                eval_batches=sum(kind == "eval" for kind, _, _ in mine),
                ms_per_step=train_ms, ms_per_step_median=statistics.median(train_ms),
                epochs=[dict(epoch=r["epoch"], train_s=r["train_s"],
                             steps_s=sum(r["step_s"]),
                             host_and_loader_s=r["train_s"] - sum(r["step_s"]),
                             eval_s=r.get("eval_s")) for r in out.history],
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            return out, text, mine

        stage("stage1", ["--preset", "us3d_stage1", "--logdir", run1,
                                      "--epochs", "1", *common], run1)
        if not all(v > 0 for v in res["stage1"]["launches"].values()):
            raise AssertionError(f"stage 1 launches {res['stage1']['launches']}")

        _, text, mine2 = stage("stage2", ["--preset", "us3d_stage2", "--logdir", run2,
                                           "--loadckpt", run1, "--epochs", "1", *common], run2)
        found = re.search(r"partially loaded (\d+) tensors from", text)
        cpu_cfg = TRAIN_PRESETS["us3d_stage2"]
        fresh = init_state(cpu_cfg, device="cpu")
        before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
        _, n_cpu = ckpt.restore_partial(run1, fresh)
        stage1_sd = torch.load(ckpt.checkpoint_path(run1, 0), weights_only=True)["model"]
        after = fresh.model.state_dict()
        own = [k for k in after if k.startswith("hourglass.")]
        if not (found and int(found.group(1)) == n_cpu > 0):
            raise AssertionError(f"stage 2 printed {found and found.group(0)}; "
                                 f"restore_partial on the CPU loads {n_cpu}")
        if not (own and all(k not in stage1_sd and torch.equal(after[k], before[k])
                            for k in own)
                and all(torch.equal(after[k], v) for k, v in stage1_sd.items())):
            raise AssertionError("the partial restore took a stage-2-only leaf or "
                                 "missed a stage-1 one")
        res["stage2"]["partially_loaded"] = n_cpu

        t3, text, mine3 = stage("resume", ["--preset", "us3d_stage2", "--logdir", run2,
                                           "--resume", "--epochs", "2", *common], run2)
        first_loss = re.search(r"Epoch 1/2, Iter 0/\d+, loss = (\S+),", text)
        if not (f"resumed from {run2} at epoch 1" in text and first_loss
                and np.isfinite(float(first_loss.group(1)))
                and [r["epoch"] for r in t3.history] == [1]):
            raise AssertionError(f"the resumed run did not start at epoch 1: {text[:600]}")
        res["resume"]["first_loss"] = float(first_loss.group(1))
        res["stage2_ms_per_step_median"] = statistics.median(
            res["stage2"]["ms_per_step"] + res["resume"]["ms_per_step"])

        for kind, want in (("train", TRAIN_LAUNCHES), ("eval", EVAL_LAUNCHES)):
            got = [l for k, _, l in mine2 + mine3 if k == kind]
            if not got or any(l != want for l in got):
                raise AssertionError(f"stage 2 {kind} launches {got}, expected {want} each")

        first = len(steps)
        reset_counts(ops)
        t = time.perf_counter()
        cli_evaluate.main(["--preset", "us3d_stage2", "--loadckpt", run2, "--datapath", root,
                           "--testlist", f"{root}/test.txt", "--batch-size", str(TRAIN_BATCH),
                           "--save-dir", dump, "--device", "cuda"])
        torch.cuda.synchronize()
        evals = [l for _, _, l in steps[first:]]
        res["evaluate"] = dict(wall_s=time.perf_counter() - t, launches=counts(ops),
                               eval_batches=len(evals), dtype="float32")
        if any(l != EVAL_LAUNCHES for l in evals):
            raise AssertionError(f"evaluate launches {evals}")
        from PIL import Image

        pngs = sorted(os.listdir(dump))
        arrays = [np.asarray(Image.open(f"{dump}/{p}")) for p in pngs]
        if not (pngs == [r.split()[0].replace(".png", "_disp.png")
                         for r in rows[TRAINER_ROWS[0]:]]
                and all(a.dtype == np.uint16 and a.shape == (1024, 1024) for a in arrays)):
            raise AssertionError(f"dumps {pngs} {[(a.dtype, a.shape) for a in arrays]}")
        res["evaluate"]["dumps"] = pngs
    res["native_sample_prep"] = native.status()
    log("trainer", json.dumps(res))
    return res


def run_remat(ops, train: dict) -> dict:
    """The train path's step with ``remat`` (``REMAT_SPECS``) through
    ``init_state``/``make_train_step``: ms per step, peak memory and
    launches per step (``REMAT_LAUNCHES``); then, from the state and batch
    of the train agreement phase (256x256, every plane kept, so no hard
    choice sits on the gradient's path), each remat step's loss terms, BN
    statistics and gradients against the plain step's (``TRAIN_BOUNDS``) in
    fp32.  In bf16 the loss terms and statistics are held to the same
    bounds, and the gradients are printed beside a second plain step's:
    bf16 sums that atomics reorder make the plain step's own gradients
    differ from run to run by more than the bounds on leaves with small
    gradients."""
    from semstereo_tpu_torch.config import TRAIN_PRESETS
    from semstereo_tpu_torch.data import SyntheticStereoDataset
    from semstereo_tpu_torch.models.semstereo import remat_components
    from semstereo_tpu_torch.train import init_state, make_grads_fn, make_train_step

    base = TRAIN_PRESETS["us3d_stage2"].replace(compute_dtype="bfloat16")
    batch = SyntheticStereoDataset(TRAIN_BATCH, 1024, 1024, base.model.maxdisp).batch(
        0, TRAIN_BATCH, "cuda")
    res = {"train_path": dict(ms_per_step_median=train["ms_per_step_median"],
                              max_memory_allocated_bytes=train["max_memory_allocated_bytes"])}
    n = REMAT_WARM + REMAT_TIMED
    for spec in REMAT_SPECS:
        cfg = base.replace(model=dataclasses.replace(base.model, remat=spec))
        state = init_state(cfg)
        train_step = make_train_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            out = train_step(state, batch)
            torch.cuda.synchronize()
            if i >= REMAT_WARM:
                times.append(1e3 * (time.perf_counter() - t0))
        launches = counts(ops)
        want = {k: v * n for k, v in REMAT_LAUNCHES[spec].items()}
        if launches != want:
            raise AssertionError(f"remat={spec} launches {launches}, expected {want}")
        if not all(np.isfinite(v.item()) for v in out.values()):
            raise AssertionError(f"remat={spec}: non-finite scalars {out}")
        res[spec] = dict(ms_per_step=times, ms_per_step_median=statistics.median(times),
                              max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                              launches_per_step={k: v // n for k, v in launches.items()})
        del state, train_step, out
    # one state and batch of the agreement phase: the plain step (twice)
    # against each remat step
    agree = agreement_cfg()
    plain = init_state(agree).model
    batch = {k: v.cuda() for k, v in agreement_batch().items()}
    bad = []
    for dtype in ("float32", "bfloat16"):
        grads_fn = make_grads_fn(agree.replace(compute_dtype=dtype))
        records = {}
        for name, spec in (("plain", False), ("plain_again", False),
                           *((s, s) for s in REMAT_SPECS)):
            model = copy.deepcopy(plain)
            model.remat = remat_components(spec)
            aux, _, _ = grads_fn(model, batch)
            records[name] = step_record(aux, model)
            del model
        for name in ("plain_again", *REMAT_SPECS):
            agreement, ok = step_agreement(records[name], records["plain"])
            res.setdefault(name, {})[f"agreement_{dtype}"] = agreement
            b = TRAIN_BOUNDS
            if dtype == "bfloat16":  # the gradients' run-to-run spread is printed
                ok = (max(agreement["loss_rel"].values()) <= b["loss"]
                      and agreement["stats_max_abs"] <= b["stats"])
            if not ok:
                bad.append((name, dtype))
        del records
    log("remat", json.dumps(res))
    if bad:
        raise AssertionError(f"remat {bad}: the step disagrees with the plain step")
    return res


def front_end_outputs(model, left, right) -> dict:
    """One request's labels and the outputs of the modules that
    ``fuse_views`` runs on the stacked views (``FUSE_MODULES``), each as
    [left views; right views] along the batch."""
    seen = {name: [] for name in FUSE_MODULES}
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, args, out, n=n: seen[n].append(out)) for n in FUSE_MODULES]
    try:
        out = model(left, right)
    finally:
        for h in hooks:
            h.remove()
    res = {k: out[k] for k in ("label_l", "label_r")}
    for name, outs in seen.items():  # two-pass: [left, right]; fused: [both]
        if isinstance(outs[0], list):  # the feature pyramid, level by level
            for i in range(len(outs[0])):
                res[f"{name}[{i}]"] = torch.cat([o[i] for o in outs])
        else:
            res[name] = torch.cat(outs)
    return res


def run_fuse_views(ops, cpu_model) -> dict:
    """The eval path with the views fused and in two passes: ``FUSE_REQUESTS``
    of each, interleaved, after one warm-up each; launches per request
    (``EVAL_LAUNCHES``) and ms per pair.  The labels and the outputs of the
    front-end modules that fusing stacks must agree within ``BF16_REL``; an
    untrained net's disparity does not survive bf16 rounding (its top-k
    plane choice flips, as in the eval agreement phase), so the bf16
    disparity is checked for finite values and its differences printed,
    and one fp32 request of each, with every plane kept, is held to
    ``FUSE_FP32_BOUNDS``.  Then one
    profiled request of each for its total kernel launches and device
    time."""
    from semstereo_tpu_torch.profile_eval import profiled

    model = copy.deepcopy(cpu_model).to("cuda", PATH_DTYPE)
    left, right = (t.to("cuda", PATH_DTYPE) for t in stereo_pair(1024, 8, seed=0))
    modes = {"two_pass": None, "fused": True}
    outs, times = {}, {m: [] for m in modes}
    for mode, fuse in modes.items():
        model.fuse_views = fuse
        model(left, right)
    torch.cuda.synchronize()
    reset_counts(ops)
    for i in range(FUSE_REQUESTS):
        for mode in (modes if i % 2 == 0 else reversed(modes)):
            model.fuse_views = modes[mode]
            t0 = time.perf_counter()
            outs[mode] = model(left, right)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0))
    launches = counts(ops)
    want = {k: v * 2 * FUSE_REQUESTS for k, v in EVAL_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"fuse_views launches {launches}, expected {want}")
    front = {}
    for mode, fuse in modes.items():
        model.fuse_views = fuse
        front[mode] = front_end_outputs(model, left, right)
    rel = {k: max_rel(v, front["two_pass"][k]) for k, v in front["fused"].items()}
    del front
    model32 = copy.deepcopy(cpu_model).to("cuda", torch.float32)
    planes = model32.maxdisp // 4 * (2 if model32.symmetric else 1)
    model32.topk = model32.refine_topk = planes
    left32, right32 = (t.to("cuda") for t in stereo_pair(1024, 8, seed=0))
    disp32 = {}
    for mode, fuse in modes.items():
        model32.fuse_views = fuse
        disp32[mode] = model32(left32, right32)["disp"][0].double().cpu()
    del model32, left32, right32
    diff32 = (disp32["fused"] - disp32["two_pass"]).abs()
    fp32 = dict(median=diff32.median().item(), max=diff32.max().item(),
                topk=planes,
                finite=bool(torch.isfinite(disp32["fused"]).all()
                            and torch.isfinite(disp32["two_pass"]).all()))
    res = dict(requests_each=FUSE_REQUESTS, max_rel=rel, fp32_disp=fp32,
               disp=disp_stats(outs["fused"]["disp"][0].float().cpu(),
                               outs["two_pass"]["disp"][0].float().cpu()),
               launches_per_request={k: v // (2 * FUSE_REQUESTS) for k, v in launches.items()})
    with tempfile.TemporaryDirectory() as tmp:
        for mode, fuse in modes.items():
            model.fuse_views = fuse
            prof = profiled(lambda: model(left, right), 1, tmp)
            res[mode] = dict(ms_per_pair=times[mode],
                             ms_per_pair_median=statistics.median(times[mode]),
                             kernel_launches_per_request=prof["kernel_launches_per_run"],
                             device_busy_ms=prof["device_busy_ms_per_run"])
    log("fuse_views", json.dumps(res))
    if not all(torch.isfinite(o["disp"][0]).all() for o in outs.values()):
        raise AssertionError("non-finite disparity")
    if max(rel.values()) > BF16_REL:
        raise AssertionError(f"fused and two-pass eval disagree: {rel}")
    if not fp32["finite"] or any(fp32[k] > b for k, b in FUSE_FP32_BOUNDS.items()):
        raise AssertionError(f"fused and two-pass fp32 disparities disagree: {fp32}")
    return res


def write_timm_checkpoint(path: str) -> None:
    """A timm-named ``mobilevitv2_100`` state_dict (``stem.*``,
    ``stages.N.blocks.M.*``) of the test oracle's backbone
    (``tests/_reference_oracle.py``, loaded by its path: a ``tests``
    package installed elsewhere would shadow the repository's), seeded."""
    import importlib.util

    where = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "_reference_oracle.py")
    spec = importlib.util.spec_from_file_location("_reference_oracle", where)
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    torch.manual_seed(0)
    sd = {}
    for k, v in oracle.FakeTimmMobileViTv2().state_dict().items():
        if k.startswith("stages_"):
            stage, rest = k[len("stages_"):].split(".", 1)
            block, tail = rest.split(".", 1)
            k = f"stages.{stage}.blocks.{block}.{tail}"
        sd[k] = v
    torch.save(sd, path)


def spawn(argv_env: list[tuple[list[str], dict]], timeout: float) -> list[str]:
    """Runs one process per (argv, extra environment) and waits for all;
    returns their outputs, raising if one fails or outlasts ``timeout``.
    Every process is ended before this returns."""
    procs = [subprocess.Popen([sys.executable, *argv], env=dict(os.environ, **env),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for argv, env in argv_env]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"process {i} exited {p.returncode}:\n{out[-3000:]}")
    return outs


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_step_worker(out_path: str) -> None:
    """One of two processes on the one card (gloo on CUDA tensors): the fp32
    agreement step on its row of the global batch of 2."""
    from semstereo_tpu_torch import ops, parallel
    from semstereo_tpu_torch.train import init_state, make_train_step

    device = parallel.init_process_group("cuda", backend="gloo")
    rank = parallel.process_index()
    cfg = agreement_cfg()
    state = init_state(cfg, device=device)
    batch = {k: v[rank::2].to(device) for k, v in agreement_batch().items()}
    train_step = make_train_step(cfg)
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    scalars = train_step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    torch.save(dict(record=step_record(scalars, state.model), launches=counts(ops), ms=ms),
               out_path)
    torch.distributed.destroy_process_group()


def dp_cli_worker(out_path: str, argv: list[str]) -> None:
    """``cli.train.main(argv)`` in a process that ``torchrun`` would start
    (the group's environment is set); its steps' times and launches go to
    ``out_path``."""
    from semstereo_tpu_torch import ops
    from semstereo_tpu_torch.cli import train as cli_train

    steps = []
    with instrumented_steps(ops, steps):
        trainer = cli_train.main(argv)
    with open(out_path, "w") as f:
        json.dump(dict(steps=steps, history=trainer.history, rank=int(os.environ["RANK"])), f,
                  default=float)


def run_data_parallel(ops, tmp: str) -> dict:
    """(a) Two processes on the one card, gloo on CUDA tensors: the fp32
    256x256 step at global batch 2 against the one-process step from the
    same weights (``TRAIN_BOUNDS``).  (b) ``cli.train`` started as
    ``torchrun`` starts it, NCCL over ``torch.cuda.device_count()``
    processes: a stage-2 epoch of the trainer phases' dataset with
    ``--data-parallel -1 --remat featup --pretrained-backbone`` (a timm
    file written here); the printed count of loaded tensors must be the
    CPU's, and every step must launch ``TRAIN_LAUNCHES``, every eval batch
    ``EVAL_LAUNCHES``."""
    from semstereo_tpu_torch.config import PRESETS
    from semstereo_tpu_torch.models import build_model
    from semstereo_tpu_torch.train import init_state, make_train_step
    from semstereo_tpu_torch.utils.timm_convert import load_and_merge

    script = os.path.abspath(__file__)
    res = {}
    # (a)
    cfg = agreement_cfg()
    state = init_state(cfg)
    scalars = make_train_step(cfg)(state, {k: v.cuda() for k, v in agreement_batch().items()})
    want = step_record(scalars, state.model)
    del state
    port = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": "2"}
    t0 = time.perf_counter()
    spawn([([script, "--worker", "dp-step", f"{tmp}/dp_step{r}.pt"],
            dict(port, RANK=str(r), LOCAL_RANK="0")) for r in range(2)], DP_TIMEOUT)
    ranks = [torch.load(f"{tmp}/dp_step{r}.pt", weights_only=False) for r in range(2)]
    agreement, ok = step_agreement(ranks[0]["record"], want)
    res["gloo_two_ranks"] = dict(
        size=256, dtype="float32", global_batch=2, wall_s=time.perf_counter() - t0,
        ms_per_step=[r["ms"] for r in ranks], launches=[r["launches"] for r in ranks],
        ranks_equal=all(torch.equal(ranks[0]["record"]["grads"][n], g)
                        for n, g in ranks[1]["record"]["grads"].items()),
        **agreement)
    if not ok or not res["gloo_two_ranks"]["ranks_equal"]:
        log("data_parallel", json.dumps(res))
        raise AssertionError("the two-process step disagrees with the one-process step")
    if any(r["launches"] != TRAIN_LAUNCHES for r in ranks):
        raise AssertionError(f"two-process launches {[r['launches'] for r in ranks]}")
    # (b)
    world = torch.cuda.device_count()
    timm = f"{tmp}/mobilevitv2_100.pth"
    write_timm_checkpoint(timm)
    n_cpu = load_and_merge(timm, build_model(PRESETS["us3d_stage2"], device="cpu"))
    root = f"{tmp}/data"
    argv = ["--preset", "us3d_stage2", "--datapath", root, "--trainlist", f"{root}/train.txt",
            "--testlist", f"{root}/test.txt", "--logdir", f"{tmp}/dp_run", "--epochs", "1",
            "--save-freq", "1", "--compute-dtype", "bfloat16", "--batch-size",
            str(TRAIN_BATCH * world), "--test-batch-size", str(TRAIN_BATCH * world),
            "--num-workers", str(TRAINER_WORKERS), "--data-parallel", "-1", "--remat", "featup",
            "--pretrained-backbone", timm, "--device", "cuda"]
    port = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "WORLD_SIZE": str(world)}
    t0 = time.perf_counter()
    outs = spawn([([script, "--worker", "dp-cli", f"{tmp}/dp_cli{r}.json", *argv],
                   dict(port, RANK=str(r), LOCAL_RANK=str(r))) for r in range(world)],
                 DP_TIMEOUT)
    wall = time.perf_counter() - t0
    found = re.search(r"loaded pretrained backbone: (\d+) leaves from", outs[0])
    runs = []
    for r in range(world):
        with open(f"{tmp}/dp_cli{r}.json") as f:
            runs.append(json.load(f))
    train_ms = [ms for kind, ms, _ in runs[0]["steps"] if kind == "train"]
    res["nccl_cli"] = dict(
        world=world, wall_s=wall, backbone_tensors_printed=found and int(found.group(1)),
        backbone_tensors_cpu=n_cpu, ms_per_step=train_ms,
        ms_per_step_median=statistics.median(train_ms) if train_ms else None,
        launches=[l for _, _, l in runs[0]["steps"]],
        epochs=[{k: v for k, v in h.items() if k != "eval"} for h in runs[0]["history"]],
        eval=runs[0]["history"][-1].get("eval"))
    log("data_parallel", json.dumps(res))
    if not (found and int(found.group(1)) == n_cpu > 0):
        raise AssertionError(f"printed {found and found.group(0)}; the CPU loads {n_cpu}")
    for run in runs:
        for kind, want_l in (("train", TRAIN_LAUNCHES), ("eval", EVAL_LAUNCHES)):
            got = [l for k, _, l in run["steps"] if k == kind]
            if not got or any(l != want_l for l in got):
                raise AssertionError(f"rank {run['rank']} {kind} launches {got}")
    if not np.isfinite(res["nccl_cli"]["eval"]["EPE"]):
        raise AssertionError("non-finite eval EPE")
    return res


def fp32_without_tf32() -> None:
    """fp32 convs and matmuls in fp32, not TF32 (cuDNN's default), so that
    the fp32 comparisons see summation order only."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def worker(argv: list[str]) -> int:
    """``--worker dp-step OUT`` or ``--worker dp-cli OUT CLI-ARGS...``: one
    process of the data-parallel phase."""
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 1
    fp32_without_tf32()
    kind, out = argv[0], argv[1]
    if kind == "dp-step":
        dp_step_worker(out)
    else:
        dp_cli_worker(out, argv[2:])
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: the port's kernels and main path run on the card")
        return 1
    t = time.perf_counter()
    from semstereo_tpu_torch import ops
    from semstereo_tpu_torch.config import PRESETS
    from semstereo_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build_s = _build.build_all()
    log(smi)
    log(f"build {build_s:.1f} s; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")

    fp32_without_tf32()
    gen = torch.Generator(device="cuda").manual_seed(0)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    t = phase("build", t)
    rows = check_k1(ops, gen, scrub) + check_k2(ops, gen, scrub)
    t = phase("kernels K1 K2", t)
    rows += check_k3(gen, scrub) + check_k4(ops, gen, scrub)
    t = phase("kernels K3 K4", t)
    del scrub

    cpu_model = seeded_model(PRESETS["us3d_stage2"], seed=0)
    path = run_path(ops, cpu_model)
    t = phase("eval path", t)
    run_agreement(ops, cpu_model)
    t = phase("eval agreement", t)
    run_fuse_views(ops, cpu_model)
    t = phase("fuse_views", t)
    del cpu_model
    train = run_train(ops)
    t = phase("train path", t)
    run_remat(ops, train)
    t = phase("remat", t)
    run_train_agreement(ops)
    t = phase("train agreement", t)
    with tempfile.TemporaryDirectory() as tmp:
        run_trainer(ops, tmp, write_dataset(f"{tmp}/data"))
        t = phase("trainer", t)
        run_data_parallel(ops, tmp)
        phase("data parallel", t)

    kernels = []
    meta = {
        "K1-s1": ("semstereo_tpu_torch/csrc/conv3d.cu",
                  "semstereo_tpu/ops/pallas/conv3d_wl.py:236"),
        "K1-s2": ("semstereo_tpu_torch/csrc/conv3d.cu",
                  "semstereo_tpu/ops/pallas/conv3d_wl.py:276"),
        "K2": ("semstereo_tpu_torch/csrc/gwc_volume.cu",
               "semstereo_tpu/ops/pallas/cost_volume_kernel.py:150"),
        "K3": ("semstereo_tpu_torch/csrc/conv3d.cu, semstereo_tpu_torch/csrc/conv3d_wgrad.cu",
               "semstereo_tpu/ops/pallas/conv3d_wl.py:346"),
        "K4": ("semstereo_tpu_torch/csrc/gwc_volume_bwd.cu",
               "semstereo_tpu/ops/pallas/cost_volume_kernel.py:280"),
    }
    for name, (source, replaces) in meta.items():
        # one request's or step's worth: every main-path shape of the
        # kernel, path dtype (K1/K2 at the eval batch, K3/K4 at the train one)
        mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
                and r.get("role", "forward") == "forward"]
        if name in ("K2", "K4"):
            mine = [r for r in mine if r["name"].endswith("symmetric")]
        lib = [r["library_ms"] for r in mine]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(train if name in ("K3", "K4") else path)["launches"][name],
            launches_eval=path["launches"][name], launches_train=train["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in mine), plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            bound_by=max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in mine if r["bound_by"] == by)),
            library_ms=None if None in lib else sum(lib),
        )
        if name == "K3":
            # the stride-1 dx is K1 and dw its own kernel; the JAX package
            # leaves the stride-2 dx to XLA, and the port to a library call
            entry["route_parts"] = {"dx_k1_ms": "cuda, csrc/conv3d.cu (K1)",
                                    "s2_dx_ms": "library, F.conv_transpose3d",
                                    "dw_ms": "cuda, csrc/conv3d_wgrad.cu"}
            entry["launches_dw"] = train["launches"]["K3-dw"]
            entry.update({k: sum(r[k] for r in mine) for k in (
                "dx_k1_ms", "s2_dx_ms", "dw_ms", "dx_library_ms", "dw_library_ms")})
        if name in ("K2", "K4"):
            entry.update(blocks_per_sm=mine[0]["blocks_per_sm"], smem_bytes=mine[0]["smem_bytes"])
        if name == "K2":
            # the train step's launch, at B = 2
            entry["ms_train_batch"] = sum(
                r["ms"] for r in rows if r["kernel"] == "K2" and r["dtype"] == "bfloat16"
                and r.get("role") == "train_batch" and r["name"].endswith("symmetric"))
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[2:]) if sys.argv[1:2] == ["--worker"] else main())
