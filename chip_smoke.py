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
12. disp parallel (after data parallel): two processes on the one card,
   gloo on CUDA tensors, splitting the cost volumes' planes (``disp = 2``,
   ``data = 1``), in one pair of processes (``chip_smoke.py --worker disp
   ...``): (a) the fp32 256x256 agreement step with both processes on the
   global batch of 2, against the one-process step from the same weights
   (``TRAIN_BOUNDS``), the two processes' gradients and updated
   parameters bitwise equal, ``TRAIN_LAUNCHES`` per process with K2's and
   K4's launch on 8 of the 16 planes each; (b) the flagship eval (US3D stage 2,
   1024x1024, bf16, B = 1, the eval path's weights): the gathered
   ``classif_att_`` output against the one-process run within
   ``BF16_REL``, and the gathered stage-2 ``cost`` within ``BF16_REL`` on
   the pixels whose top-k planes both runs chose alike (at least
   ``DISP_SAME_TOPK`` of them), ``EVAL_LAUNCHES``
   per request per process, ms per pair per process (two processes share
   the card and gloo stages through the host, so this is no speed-up);
   then one fp32 256x256 request with every /4 plane kept, its disparity
   within ``FUSE_FP32_BOUNDS`` of one process's; (c) ``cli.train
   --disp-parallel 2`` in the group the worker joined, for the trainer
   phase's stage-2 epoch (bf16, from its stage-1 checkpoint): both
   processes loading one process's rows, its first step's loss within
   ``DISP_CLI_LOSS_REL`` of that one-process epoch's,
   both processes' eval results within ``DISP_CLI_EVAL_REL`` of one
   process's eval of the disp run's checkpoint (``Trainer.evaluate`` at
   the run's compute dtype), every step and eval batch launching
   ``TRAIN_LAUNCHES`` and ``EVAL_LAUNCHES`` per process.
13. space parallel (after disp parallel): two processes on the one card,
   gloo on CUDA tensors, splitting the images' rows (``space = 2``,
   ``data = 1``; ``chip_smoke.py --worker space ...``): (a) the fp32
   256x256 agreement step on each process's 128 rows of the global batch
   of 2, against the one-process step (``TRAIN_BOUNDS``), the two
   processes' gradients and updated parameters bitwise equal,
   ``TRAIN_LAUNCHES`` per process with K2's and K4's launch on 16 of the 32
   /8 rows each; (b) the flagship eval (US3D stage 2, 1024x1024, bf16, B =
   1) on 512 rows a process: the gathered ``label_l`` and /8 attention
   volume against one process's within ``BF16_REL``, the stage-2 cost
   within ``SPACE_COST_REL`` on the pixels whose top-k choice equals one
   process's, that share (at least ``SPACE_SAME_TOPK``) and the
   disparity's differences; the same request in fp32 with every /4 plane
   kept, its disparity within ``FUSE_FP32_BOUNDS`` of one process's; the
   bf16 disparity's median difference within ``SPACE_BF16_LEVEL`` times one
   process's bf16 against fp32; the differing top-k share in the band
   around the slab boundary within ``SPACE_BAND_EXCESS`` of the median
   band's; ``EVAL_LAUNCHES`` per request per process with K2 on 64 of
   the 128 /8 rows, each process's peak memory beside one process's, ms
   per pair per process (two processes share the card and gloo stages
   through the host: no speed of the split); one fp32 256x256 request
   with every /4 plane kept, its disparity within ``FUSE_FP32_BOUNDS`` of
   one process's; the train path's step (1024x1024, batch 2, bf16) at
   ``space = 2``, its launches and each process's peak memory beside the
   train path's; (c) ``cli.train --space-parallel 2`` for the trainer
   phase's stage-2 epoch: both processes loading one process's rows, the
   first batch each moved to the card equal to one process's cut by
   height, its first step's loss within ``SPACE_CLI_LOSS_REL`` of the
   one-process epoch's, both processes' eval results within
   ``SPACE_CLI_EVAL_REL`` of one process's eval of the space run's
   checkpoint, every step and eval batch launching ``TRAIN_LAUNCHES`` and
   ``EVAL_LAUNCHES`` per process; (d) four processes at ``space = 4``
   (``chip_smoke.py --worker space4 ...``, 256 of the 1024 rows each):
   the flagship request in fp32 with every /4 plane kept, its disparity
   within ``FUSE_FP32_BOUNDS`` of one process's, and the train path's step,
   its launches, K2's and K4's 32 of 128 /8 rows and each process's peak
   memory beside space 2's and one process's.
14. disp x space parallel (after space parallel): four processes on the
   one card, gloo on CUDA tensors, splitting the volumes' planes and the
   images' rows at once (``disp = 2``, ``space = 2``, ``data = 1``;
   rank = disp_index * 2 + space_index; ``chip_smoke.py --worker
   disp-space ...``): (a) the fp32 256x256 agreement step on each
   process's 128 rows of the global batch of 2 against the one-process
   step (``TRAIN_BOUNDS``), every process's gradients and updated
   parameters equal to process 0's bit for bit, ``TRAIN_LAUNCHES`` per
   process with K2 and K4 on 8 of the 16 planes of 16 of the 32 /8 rows;
   (b) the flagship request on 512 rows a process: in fp32 with every /4
   plane kept, every process's disparity within ``FUSE_FP32_BOUNDS`` of one
   process's, and the processes of a disp group, which compute the same
   rows, equal bit for bit under cuDNN's deterministic algorithms (its
   default fp32 algorithm for the front end's 2-D transposed convs adds
   with atomics, so that even one process's request does not repeat
   itself bit for bit);
   in bf16, the gathered ``label_l`` and /8 attention volume within
   ``BF16_REL``, the stage-2 cost within ``SPACE_COST_REL`` on the pixels
   whose top-k choice equals one process's (at least ``SPACE_SAME_TOPK``),
   the median disparity difference within ``SPACE_BF16_LEVEL`` times the
   bf16 level, and the differing top-k choices in the bands around the
   slab boundaries within ``SPACE_BAND_EXCESS`` of the median band, along
   the rows (``SPACE_BAND_ROWS``) and along the /4 planes
   (``DISP_SPACE_PLANE_BAND``); the processes of a disp group equal;
   ``EVAL_LAUNCHES`` per request with K2 on 8 planes of 64 /8 rows, peak
   memory and ms per pair per process (four processes share the card and
   gloo stages through the host: no speed of the split); (c) ``cli.train
   --disp-parallel 2 --space-parallel 2`` for the trainer phase's stage-2
   epoch: every process loading one process's rows, its first batch on the
   card one process's cut by height, its first loss within
   ``DISP_CLI_LOSS_REL`` of the one-process epoch's, its eval within
   ``SPACE_CLI_EVAL_REL`` of one process's eval of its checkpoint; then
   ``cli.evaluate`` with the same flags on that checkpoint, within
   ``SPACE_CLI_EVAL_REL`` of the one-process ``cli.evaluate``; every step
   and eval batch launching ``TRAIN_LAUNCHES`` and ``EVAL_LAUNCHES``; (d)
   the train path's step per process: launches, K2's and K4's 8 planes of
   64 /8 rows and peak memory beside one process's, space 2's and space
   4's; (e) eight processes at ``data = 2 x disp = 2 x space = 2``, the
   JAX package's composed mesh (``chip_smoke.py --worker dds-step ...``):
   the fp32 256x256 agreement step against one process's
   (``TRAIN_BOUNDS``), every process equal to process 0 bit for bit.
15. bf16 curves (after the train agreement): the JAX package's 200-step
   bf16-against-fp32 curves, on the tiny config (maxdisp 16, topk 4,
   windows (1, 2, 2), 32x32, batch 2, seg and LRSC losses, lr 1e-3): first
   each kernel call of one bf16 step (K1, K3's dw, K2, K4 at the tiny
   shapes) against its plain version within ``REL_TOL``, each of the four
   called; then, from the fp32 master of each of ``convergence.BF16_SEEDS``
   (1-5), a curve in bf16 and one in fp32, and a second fp32 curve from
   the first seed's, over the 4 batches of 8 synthetic samples in order,
   K1-K4 launched every step, each curve a process of its own on the card in
   PyTorch's deterministic mode (``convergence.run_curves``, all at once),
   every loss finite: the fp32 repeat's losses equal the fp32 curve's bit
   for bit; the first seed's curves' mean loss over their final 10 steps
   (their tails) below ``BF16_CURVE_FALL`` of their first losses (JAX's
   second bound); and over the seeds, the median bf16 tail within
   ``convergence.TAIL_REL`` of the median fp32 tail (JAX's first bound,
   held to the medians) and every tail below ``convergence.FALL_TRACKS``
   of its first loss (``convergence.tail_verdict``).
16. convergence (after the bf16 curves): the port's convergence harness
   (``python -m semstereo_tpu_torch.convergence``, the counterpart of the
   JAX package's ``benchmarks/convergence.py``) through ``cli.train`` and
   ``cli.evaluate`` on its learnable 32x32 US3D-format data, three
   processes at once: the 60-epoch overfit in fp32 and in bf16 (EPE < 1 px,
   mIoU > 0.95 on the train list) and the 12-epoch two-stage recipe (stage
   2's EPE below stage 1's, the seg and LRSC losses falling, the count of
   partially restored tensors equal to the CPU's, ``cli.evaluate`` within
   1e-4 px of the last in-training EPE); every ``pass_*`` key true, and
   every kernel launched in the bf16 overfit.  Prints each run's final
   EPE, D1 and mIoU, its wall time and the restore count.

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
# modules after the front end that run on the stacked views when fused.
FUSE_REQUESTS = 10
FUSE_MODULES = ("chal_1", "chal_2", "concat_feature")
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
# The disp-parallel phase: processes per disp group, timed requests per
# process at the flagship after one warm-up, and the least share of /4
# pixels whose top-k choice must agree with one process's for the stage-2
# cost comparison (1.0 measured in three runs on the H100: the split computes
# each plane from the same operands in the same order, so only a bf16
# near-tie flipped by another summation order in a slab's BatchNorm could
# part them).
DISP = 2
DISP_TIMED = 3
DISP_SAME_TOPK = 0.99
# (c): the first step's loss against the one-process epoch's (relative;
# 3.9e-4, 2.2e-4, 8.5e-4 and 1.3e-4 in four runs on the H100: the volume's
# train BatchNorm sums its slabs in another order, bf16 rounds the rest
# otherwise, and the training top-k flips near-ties of the untrained net),
# and each eval result against one process's eval of the same checkpoint
# (relative, absolute below 1: shares and losses alike; 0 measured on the
# H100), which computes each plane as the split does.  A wrong slab, halo
# or gather moves them by whole percent; the rows loaded are compared
# exactly.
DISP_CLI_LOSS_REL = 5e-3
DISP_CLI_EVAL_REL = 1e-5
# The space-parallel phase: processes per space group, timed requests per
# process at the flagship after one recorded request, and the least share
# of /4 pixels whose top-k choice must agree with one process's.  Unlike
# the disp split, which computed each plane from the same operands as one
# process, a row slab runs the front end's cuDNN convs at other shapes,
# which round otherwise in bf16, and the untrained net's near-ties of the
# top-24 flip: 76.2 %, 79.0 %, 79.0 % and 79.0 % equal in four runs on an
# H100 80GB HBM3 at 700 W, with label_l and the /8 attention volume within
# BF16_REL (9.6e-3 and 1.3e-2) and the stage-2 cost on the equal pixels,
# which the flipped near-ties around them feed through the /4 convs,
# within SPACE_COST_REL (4.4e-2).  A wrong halo or reduction moves
# boundary rows by the order of the values themselves, and breaks the fp32
# requests' FUSE_FP32_BOUNDS.  Since a halo fault touches only a few /4
# rows around the slab boundary, three witnesses part it from rounding:
# the flagship request in fp32 with every /4 plane kept, held to
# FUSE_FP32_BOUNDS; the bf16 split's median disparity difference (columns
# >= 32), held to SPACE_BF16_LEVEL times one process's bf16 request's
# against its fp32 request on the same weights (the bf16 level); and the
# share of differing top-k choices in bands of SPACE_BAND_ROWS /4 rows,
# where the band centred on the slab boundary may exceed the median band
# by SPACE_BAND_EXCESS at most (rounding spreads evenly, a halo fault
# makes the boundary rows' choices near random).  These three were set
# before their first run on the card (PERF.md section 6).
SPACE = 2
SPACE_TIMED = 3
SPACE_SAME_TOPK = 0.6
SPACE_COST_REL = 0.1
SPACE_BF16_LEVEL = 2.0
SPACE_BAND_ROWS = 8
SPACE_BAND_EXCESS = 0.1
# (d): the space 4 run's processes (1024 rows, 256 a slab).
SPACE4 = 4
# (c): the first step's loss against the one-process epoch's (relative;
# 6.9e-4, 0, 7.2e-5 and 3.8e-4 in those runs), and each eval result against
# one process's eval of the same checkpoint (relative, absolute below 1;
# 3.1e-3, 8.2e-4, 1.7e-4 and 2.5e-4, the bf16 rounding above moving a few
# pixels' choices).  A wrong slab or halo moves them by whole percent; the
# rows and first batch loaded are compared exactly.
SPACE_CLI_LOSS_REL = 5e-3
SPACE_CLI_EVAL_REL = 1e-2
# The disp x space phase (disp = DISP, space = SPACE, four processes): the
# space phase's bounds hold its bf16 flagship request, the boundary bands
# measured in the row direction (SPACE_BAND_ROWS) and in the plane
# direction: the share of /4 pixels whose top-k choice of each /4 plane
# differs from one process's, in bands of DISP_SPACE_PLANE_BAND planes, one
# centred on the /8 plane slabs' boundary (plane 16 of 32).  Set before the
# phase's first run on the card (PERF.md section 6).
DISP_SPACE_PLANE_BAND = 4
# The bf16 training phase: the JAX package's test_bf16_fp32_loss_curve_200steps
# (tests/test_train_integration.py) at convergence.BF16_STEPS steps from the
# fp32 masters of convergence.BF16_SEEDS (the config's default first, as in
# the JAX test); the share of its first loss that the first seed's curves'
# tails must fall below (JAX's second bound).  On the card a train step
# repeats itself only in PyTorch's deterministic mode (the scatter-adds of
# the gathers' backward, cuDNN's algorithms), which the curves' processes
# run in, with an fp32 repeat that must equal the fp32 curve bit for bit.
# JAX's first bound, a 10 % gap of the two dtypes' tails, is held to the
# median tails over the seeds (``convergence.tail_verdict``): one seed's
# tail moves with the plateaus that the recipe meets at some seeds in
# either dtype, on the CPU and in JAX as on the card (PERF.md section 6).
BF16_CURVE_FALL = 0.2
# The convergence phase: the harness's runs, three processes at once.
CONVERGENCE_RUNS = ("overfit", "overfit_bf16", "twostage")
CONVERGENCE_TIMEOUT = 900
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


def seeded_model(cfg, seed: int, mesh=None):
    """fp32 CPU model: seeded init, non-trivial BN statistics and affine, and
    x8 classifier output kernels (peaked disparity posteriors); split over
    ``mesh``'s disp axis when one is given."""
    from semstereo_tpu_torch.models import build_model
    from semstereo_tpu_torch.nn import BatchNorm

    model = build_model(cfg, device="cpu", seed=seed, mesh=mesh)
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


def run_path(ops, cpu_model, n_warm=2, n_timed=10):
    model = copy.deepcopy(cpu_model).to("cuda", PATH_DTYPE)
    left, right = (t.to("cuda", PATH_DTYPE) for t in stereo_pair(1024, 8, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    out = None
    for i in range(n_warm + n_timed):
        t0 = time.perf_counter()
        out = model(left, right)
        torch.cuda.synchronize()
        if i >= n_warm:
            times.append(1e3 * (time.perf_counter() - t0))
    launches = ops.launch_counts()
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
    ops.reset_launch_counts()
    out = model(left.to("cuda", dtype), right.to("cuda", dtype))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if ops.launch_counts() != EVAL_LAUNCHES:
        raise AssertionError(f"{dtype} card run launches {ops.launch_counts()}")
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
    ops.reset_launch_counts()
    times, scalars = [], []
    for i in range(n):
        t0 = time.perf_counter()
        out = train_step(state, batch)
        torch.cuda.synchronize()
        if i >= TRAIN_WARM:
            times.append(1e3 * (time.perf_counter() - t0))
        scalars.append({k: v.item() for k, v in out.items()})
    launches = ops.launch_counts()
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
    ops.reset_launch_counts()
    aux_card, _, _ = grads_fn(card_model, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
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
                before, t0 = ops.launch_counts(), time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                after = ops.launch_counts()
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
            ops.reset_launch_counts()
            t = time.perf_counter()
            out = cli_train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = ops.launch_counts()
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
        ops.reset_launch_counts()
        t = time.perf_counter()
        cli_evaluate.main(["--preset", "us3d_stage2", "--loadckpt", run2, "--datapath", root,
                           "--testlist", f"{root}/test.txt", "--batch-size", str(TRAIN_BATCH),
                           "--save-dir", dump, "--device", "cuda"])
        torch.cuda.synchronize()
        evals = [l for _, _, l in steps[first:]]
        res["evaluate"] = dict(wall_s=time.perf_counter() - t, launches=ops.launch_counts(),
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
        ops.reset_launch_counts()
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            out = train_step(state, batch)
            torch.cuda.synchronize()
            if i >= REMAT_WARM:
                times.append(1e3 * (time.perf_counter() - t0))
        launches = ops.launch_counts()
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
    """One request's labels, the outputs of the modules after the front
    end that ``fuse_views`` runs on the stacked views (``FUSE_MODULES``),
    and the front end's pyramid (``SemStereo._fronts``, as ``feature_up``:
    a replayed front end runs no module hook), each as [left views; right
    views] along the batch."""
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
        res[name] = torch.cat(outs)
    with torch.inference_mode():
        _, feat_l, feat_r = model._fronts(left, right, bool(model.fuse_views))
    for i, level in enumerate(zip(feat_l, feat_r)):
        res[f"feature_up[{i}]"] = torch.cat(level)
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
    from stereobench.tracing import Tracer, summarize

    model = copy.deepcopy(cpu_model).to("cuda", PATH_DTYPE)
    left, right = (t.to("cuda", PATH_DTYPE) for t in stereo_pair(1024, 8, seed=0))
    modes = {"two_pass": None, "fused": True}
    outs, times = {}, {m: [] for m in modes}
    for mode, fuse in modes.items():
        model.fuse_views = fuse
        model(left, right)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for i in range(FUSE_REQUESTS):
        for mode in (modes if i % 2 == 0 else reversed(modes)):
            model.fuse_views = modes[mode]
            t0 = time.perf_counter()
            outs[mode] = model(left, right)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0))
    launches = ops.launch_counts()
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
    for mode, fuse in modes.items():
        model.fuse_views = fuse
        prof = summarize(Tracer().profile(lambda: model(left, right), 1), {}, 1)
        res[mode] = dict(ms_per_pair=times[mode],
                         ms_per_pair_median=statistics.median(times[mode]),
                         kernel_launches_per_request=prof["kernels"],
                         device_busy_ms=1e3 * prof["busy_s"])
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


def spawn(argv_env: list[tuple[list[str], dict]], timeout: float, check: bool = True) -> list[str]:
    """Runs one process per (argv, extra environment) and waits for all;
    returns their outputs, raising if one outlasts ``timeout`` or, with
    ``check``, exits other than 0.  Every process is ended before this
    returns."""
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
        if check and p.returncode != 0:
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
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    scalars = train_step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    torch.save(dict(record=step_record(scalars, state.model), launches=ops.launch_counts(), ms=ms),
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


def planes(ops) -> dict:
    """The planes K2 and K4 computed since the counts were reset."""
    return {"K2": ops.gwc_volume_norm.planes, "K4": ops.gwc_volume_norm_bwd.planes}


def volume_records(model, left, right) -> dict:
    """One request, recording the whole /8 attention volume (the
    classifier's output, gathered under a mesh: the trilinear resize's
    input), the whole stage-2 cost and its top-k samples (the top-k
    regression's inputs) and the disparity, on the CPU in fp32."""
    from semstereo_tpu_torch.models import semstereo as sem

    seen = {}
    resize, regress = sem.resize_trilinear, sem.regression_topk

    def rec_resize(x, *a):
        seen["att"] = x.float().cpu()
        return resize(x, *a)

    def rec_regress(cost, samples, k):
        seen["cost"], seen["samples"] = cost.float().cpu(), samples.float().cpu()
        return regress(cost, samples, k)

    sem.resize_trilinear, sem.regression_topk = rec_resize, rec_regress
    try:
        out = model(left, right)
        torch.cuda.synchronize()
    finally:
        sem.resize_trilinear, sem.regression_topk = resize, regress
    seen["disp"] = out["disp"][0].float().cpu()
    return seen


def disp_worker(out_path: str, cli_argv: list[str]) -> None:
    """One of the two processes of the disp-parallel phase (docstring, item
    12), gloo on CUDA tensors."""
    import torch.distributed.nn.functional as dist_fn

    from semstereo_tpu_torch import ops, parallel
    from semstereo_tpu_torch.cli import train as cli_train
    from semstereo_tpu_torch.config import PRESETS, ParallelConfig
    from semstereo_tpu_torch.train import init_state, make_train_step

    device = parallel.init_process_group("cuda", backend="gloo")
    mesh = parallel.make_mesh(-1, DISP)
    res = {}
    # does torch.distributed.nn's all_gather differentiate under gloo on
    # CUDA tensors? (the port's gather_planes does not use it)
    probe = torch.ones(4, device=device, requires_grad=True)
    try:
        torch.stack(dist_fn.all_gather(probe)).sum().backward()
        res["dist_nn_all_gather_backward"] = "ran"
    except Exception as e:  # recorded, not needed: the port has its own adjoint
        res["dist_nn_all_gather_backward"] = f"{type(e).__name__}: {str(e)[:200]}"
    # (a)
    cfg = agreement_cfg().replace(parallel=ParallelConfig(disp=DISP))
    state = init_state(cfg, device=device, mesh=mesh)
    batch = {k: v.to(device) for k, v in agreement_batch().items()}
    train_step = make_train_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    scalars = train_step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    record = step_record(scalars, state.model)
    record["params"] = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    res["train"] = dict(record=record, launches=ops.launch_counts(), planes=planes(ops), ms=ms)
    del state
    # (b)
    model = seeded_model(PRESETS["us3d_stage2"], seed=0, mesh=mesh).to(device, PATH_DTYPE)
    left, right = (t.to(device, PATH_DTYPE) for t in stereo_pair(1024, 8, seed=0))
    rec = volume_records(model, left, right)
    ops.reset_launch_counts()
    times = []
    for _ in range(DISP_TIMED):
        t0 = time.perf_counter()
        model(left, right)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    res["eval"] = dict(records=rec, ms=times, launches=ops.launch_counts(), planes=planes(ops))
    del model
    model = seeded_model(agreement_cfg().model, seed=0, mesh=mesh).to(device)
    left, right = stereo_pair(256, 5, seed=1)
    res["eval_fp32"] = model(left.to(device), right.to(device))["disp"][0].cpu()
    del model
    # (c)
    steps = []
    with instrumented_steps(ops, steps):
        trainer = cli_train.main(cli_argv)
    loader = trainer.train_loader
    res["cli"] = dict(steps=steps, history=trainer.history, rows=loader._indices().tolist(),
                      shard=(loader.shard_index, loader.shard_count))
    torch.save(res, out_path)
    torch.distributed.destroy_process_group()


def logged_eval(text: str) -> dict:
    """The first ``avg_test_scalars`` dict a trainer printed, as floats."""
    line = next(ln for ln in text.splitlines() if ln.startswith("avg_test_scalars"))
    return {k: float(v) for k, v in re.findall(r"'(\w+)': (?:np\.float64\()?([^,)}]+)", line)}


def run_disp_parallel(ops, tmp: str) -> dict:
    """The disp-parallel phase (docstring, item 12): the one-process
    references, then the two processes.  The one-process epoch of (c) is
    the trainer phase's stage 2 in ``tmp/stage2``."""
    from semstereo_tpu_torch.cli import train as cli_train
    from semstereo_tpu_torch.config import PRESETS
    from semstereo_tpu_torch.train import checkpoint as ckpt
    from semstereo_tpu_torch.train import init_state, make_train_step
    from semstereo_tpu_torch.train.trainer import Trainer

    script = os.path.abspath(__file__)
    cfg = agreement_cfg()
    state = init_state(cfg)
    want = step_record(make_train_step(cfg)(state, {k: v.cuda() for k, v in
                                                     agreement_batch().items()}), state.model)
    del state
    model = seeded_model(PRESETS["us3d_stage2"], seed=0).to("cuda", PATH_DTYPE)
    one = volume_records(model, *(t.to("cuda", PATH_DTYPE) for t in stereo_pair(1024, 8, 0)))
    del model
    model = seeded_model(cfg.model, seed=0).cuda()
    left, right = stereo_pair(256, 5, seed=1)
    one_fp32 = model(left.cuda(), right.cuda())["disp"][0].cpu()
    del model
    root = f"{tmp}/data"
    cli_argv = ["--preset", "us3d_stage2", "--datapath", root, "--trainlist",
                f"{root}/train.txt", "--testlist", f"{root}/test.txt", "--loadckpt",
                f"{tmp}/stage1", "--epochs", "1", "--save-freq", "1", "--compute-dtype",
                "bfloat16", "--batch-size", str(TRAIN_BATCH), "--test-batch-size",
                str(TRAIN_BATCH), "--num-workers", str(TRAINER_WORKERS), "--device", "cuda",
                "--logdir", f"{tmp}/disp_run", "--disp-parallel", str(DISP)]
    port = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "WORLD_SIZE": str(DISP)}
    t0 = time.perf_counter()
    spawn([([script, "--worker", "disp", f"{tmp}/disp{r}.pt", *cli_argv],
            dict(port, RANK=str(r), LOCAL_RANK="0")) for r in range(DISP)], DP_TIMEOUT)
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/disp{r}.pt", weights_only=False) for r in range(DISP)]
    failures = []
    # (a)
    tr = [r["train"] for r in ranks]
    agreement, ok = step_agreement(tr[0]["record"], want)
    equal = all(torch.equal(tr[0]["record"][part][n], t) for part in ("grads", "params")
                for n, t in tr[1]["record"][part].items())
    d8 = 2 * agreement_cfg().model.maxdisp // 8
    res = {"wall_s": wall, "dist_nn_all_gather_backward": ranks[0]["dist_nn_all_gather_backward"],
           "train": dict(size=256, dtype="float32", global_batch=2,
                         ms_per_step=[t["ms"] for t in tr],
                         launches=[t["launches"] for t in tr], planes=[t["planes"] for t in tr],
                         ranks_equal=equal, **agreement)}
    if not ok:
        failures.append("the disp=2 step disagrees with the one-process step")
    if not equal:
        failures.append("the two processes' gradients or parameters differ")
    if any(t["launches"] != TRAIN_LAUNCHES or t["planes"] != {"K2": d8 // DISP, "K4": d8 // DISP}
           for t in tr):
        failures.append("disp=2 train launches or planes")
    # (b)
    ev = [r["eval"] for r in ranks]
    got = ev[0]["records"]
    same = (got["samples"] == one["samples"]).all(dim=1)  # [B, H4, W4]
    cost_diff = (got["cost"] - one["cost"]).abs().amax(dim=1)[same]
    cost_rel = float(cost_diff.max() / one["cost"].abs().max()) if same.any() else float("inf")
    att_rel = max_rel(got["att"], one["att"])
    fp32 = (ranks[0]["eval_fp32"].double() - one_fp32.double()).abs()[:, :, 32:]
    per_request = [{k: v // DISP_TIMED for k, v in e["launches"].items()} for e in ev]
    res["eval"] = dict(
        size=1024, dtype="bfloat16", note="two processes share one card; gloo stages through "
        "the host", ms_per_pair=[e["ms"] for e in ev],
        ms_per_pair_median=[statistics.median(e["ms"]) for e in ev], launches=per_request,
        planes_per_request=[{k: v // DISP_TIMED for k, v in e["planes"].items()} for e in ev],
        att_max_rel=att_rel, cost_max_rel_same_topk=cost_rel,
        same_topk_share=float(same.double().mean()),
        ranks_equal=all(torch.equal(ev[0]["records"][k], ev[1]["records"][k])
                        for k in ("att", "cost", "samples", "disp")),
        disp_median_abs_px=float((got["disp"] - one["disp"]).abs().median()),
        fp32_256=dict(median=float(fp32.median()), max=float(fp32.max())))
    if not (att_rel <= BF16_REL and cost_rel <= BF16_REL
            and res["eval"]["same_topk_share"] >= DISP_SAME_TOPK and res["eval"]["ranks_equal"]):
        failures.append("the disp=2 eval's volumes disagree with the one-process run")
    if any(e["launches"] != {k: v * DISP_TIMED for k, v in EVAL_LAUNCHES.items()}
           for e in ev) or any(
            p != {"K2": 16 // DISP, "K4": 0} for p in res["eval"]["planes_per_request"]):
        failures.append("disp=2 eval launches or planes")
    if not (fp32.median() <= FUSE_FP32_BOUNDS["median"] and fp32.max() <= FUSE_FP32_BOUNDS["max"]):
        failures.append("the disp=2 fp32 eval's disparity disagrees with one process's")
    # (c)
    disp_run = f"{tmp}/disp_run"
    sd = [torch.load(f"{tmp}/{run}/checkpoint_000000.pt", weights_only=True)["model"]
          for run in ("stage2", "disp_run")]
    moved = torch.cat([(sd[1][n] - p).abs().ravel() for n, p in sd[0].items()
                       if "running_" not in n]) / agreement_cfg().optim.lr
    cli = [r["cli"] for r in ranks]
    logs = []
    for run in ("stage2", "disp_run"):
        with open(f"{tmp}/{run}/log.log") as f:
            logs.append(f.read())
    first_loss = [float(re.search(r"Epoch 0/1, Iter 0/\d+, loss = (\S+),", text).group(1))
                  for text in logs]
    # one process's eval of the disp run's checkpoint, as the run evaluated
    one_cfg, _ = cli_train.parse_config(cli_argv[:cli_argv.index("--disp-parallel")])
    trainer = Trainer(one_cfg, device="cuda")
    trainer.state = ckpt.restore_checkpoint(disp_run, init_state(one_cfg))
    want_eval = trainer.evaluate()
    trainer.train_loader.set_epoch(0)
    want_rows = trainer.train_loader._indices().tolist()
    del trainer
    eval_rel = {k: max(abs(c["history"][-1]["eval"].get(k, np.inf) - v) / max(abs(v), 1.0)
                    for c in cli)
                for k, v in want_eval.items()}
    res["cli"] = dict(
        ms_per_step=[[ms for kind, ms, _ in c["steps"] if kind == "train"] for c in cli],
        param_diff_over_lr_max=float(moved.max()), param_diff_over_lr_median=float(moved.median()),
        steps=[ln for ln in logs[1].splitlines() if ln.startswith("Epoch 0/1, Iter")],
        one_steps=[ln for ln in logs[0].splitlines() if ln.startswith("Epoch 0/1, Iter")],
        first_loss_rel=abs(first_loss[1] - first_loss[0]) / abs(first_loss[0]),
        eval=cli[0]["history"][-1]["eval"], one_process_eval_of_checkpoint=want_eval,
        eval_rel_max=max(eval_rel.values()), one_epoch_eval=logged_eval(logs[0]))
    for c in cli:
        for kind, want_l in (("train", TRAIN_LAUNCHES), ("eval", EVAL_LAUNCHES)):
            got_l = [l for k, _, l in c["steps"] if k == kind]
            if not got_l or any(l != want_l for l in got_l):
                failures.append(f"disp=2 CLI {kind} launches {got_l}")
    if any(c["rows"] != want_rows or c["shard"] != (0, 1) for c in cli):
        failures.append(f"disp=2 CLI rows {[(c['shard'], c['rows']) for c in cli]}, "
                        f"one process's {want_rows}")
    if sd[0].keys() != sd[1].keys():
        failures.append("the disp=2 CLI checkpoint's leaves differ from one process's")
    if not res["cli"]["first_loss_rel"] <= DISP_CLI_LOSS_REL:
        failures.append(f"the disp=2 CLI first loss {first_loss[1]} against {first_loss[0]}")
    if any(set(c["history"][-1]["eval"]) != set(want_eval) for c in cli) or not all(
            np.isfinite(v) and v <= DISP_CLI_EVAL_REL for v in eval_rel.values()):
        failures.append(f"the disp=2 CLI eval against one process's of its checkpoint: "
                        f"{eval_rel}")
    log("disp_parallel", json.dumps(res))
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def rows_launched(ops) -> dict:
    """The rows K2 and K4 computed since the counts were reset (a launch's
    rows counted once)."""
    return {"K2": ops.gwc_volume_norm.rows, "K4": ops.gwc_volume_norm_bwd.rows}


def row_slab(t: torch.Tensor, mesh, axis: int = 1) -> torch.Tensor:
    r0, n = mesh.row_slab(t.shape[axis])
    return t.narrow(axis, r0, n)


def eval_records(model, left, right) -> dict:
    """One request: its label logits, disparity, /8 attention volume (the
    trilinear resize's input), stage-2 cost and top-k samples (the top-k
    regression's inputs), on the CPU (the process's rows of each under a
    row split); with the peak memory it took from a reset."""
    from semstereo_tpu_torch.models import semstereo as sem

    seen = {}
    resize, regress = sem.resize_trilinear, sem.regression_topk

    def rec_resize(x, *a):
        seen["att"] = x.float().cpu()
        return resize(x, *a)

    def rec_regress(cost, samples, k):
        seen["cost"], seen["samples"] = cost.float().cpu(), samples.float().cpu()
        return regress(cost, samples, k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sem.resize_trilinear, sem.regression_topk = rec_resize, rec_regress
    try:
        out = model(left, right)
        torch.cuda.synchronize()
    finally:
        sem.resize_trilinear, sem.regression_topk = resize, regress
    seen["peak_bytes"] = torch.cuda.max_memory_allocated()
    seen["disp"] = out["disp"][0].float().cpu()
    seen["label"] = out["label_l"].float().cpu()
    return seen


def every_plane(model_cfg):
    """``model_cfg`` (maxdisp 64) with every /4 plane kept by the top-k
    stages (topk = refine_topk = 32), as ``agreement_cfg``'s model."""
    return dataclasses.replace(model_cfg, topk=32, refine_topk=32)


def boundary_bands(same: torch.Tensor, boundary: int, width: int) -> dict:
    """The share of /4 pixels whose top-k choice differs from one process's
    in bands of ``width`` rows, one of them centred on the slab boundary at
    /4 row ``boundary``: a halo fault lands in that band, a rounding
    difference anywhere."""
    differs = ~same  # [B, H4, W4]
    starts = list(range((boundary - width // 2) % width, differs.shape[1] - width + 1, width))
    shares = [float(differs[:, r:r + width].double().mean()) for r in starts]
    at = starts.index(boundary - width // 2)
    others = shares[:at] + shares[at + 1:]
    return dict(width=width, rows=[(r, r + width) for r in starts], shares=shares,
                boundary=shares[at], others_median=statistics.median(others))


def train_1024_step(ops, device, mesh=None) -> dict:
    """The train path's step (US3D stage 2, 1024x1024, batch 2, bf16) after
    one warm-up step, with its peak memory from a reset; on the process's
    row slab of the batch under a mesh (and its plane slabs of the volumes
    under a disp axis)."""
    from semstereo_tpu_torch.config import ParallelConfig, TRAIN_PRESETS
    from semstereo_tpu_torch.data import SyntheticStereoDataset
    from semstereo_tpu_torch.parallel import slab_rows
    from semstereo_tpu_torch.train import init_state, make_train_step

    cfg = TRAIN_PRESETS["us3d_stage2"].replace(compute_dtype="bfloat16")
    if mesh is not None:
        cfg = cfg.replace(parallel=ParallelConfig(disp=mesh.disp, space=mesh.space))
    state = init_state(cfg, device=device, mesh=mesh)
    batch = SyntheticStereoDataset(TRAIN_BATCH, 1024, 1024, cfg.model.maxdisp).batch(
        0, TRAIN_BATCH)
    batch = {k: v.to(device) for k, v in slab_rows(batch, mesh).items()}
    step = make_train_step(cfg)
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(state, batch)
    torch.cuda.synchronize()
    return dict(ms=1e3 * (time.perf_counter() - t0), peak_bytes=torch.cuda.max_memory_allocated(),
                launches=ops.launch_counts(), rows=rows_launched(ops), planes=planes(ops),
                loss=float(out["loss"]))


def space_worker(out_path: str, cli_argv: list[str]) -> None:
    """One of the two processes of the space-parallel phase (docstring,
    item 13), gloo on CUDA tensors."""
    from semstereo_tpu_torch import ops, parallel
    from semstereo_tpu_torch.config import PRESETS, ParallelConfig
    from semstereo_tpu_torch.train import init_state, make_train_step

    device = parallel.init_process_group("cuda", backend="gloo")
    mesh = parallel.make_mesh(-1, 1, SPACE)
    res = {}
    # (a)
    cfg = agreement_cfg().replace(parallel=ParallelConfig(space=SPACE))
    state = init_state(cfg, device=device, mesh=mesh)
    batch = {k: v.to(device) for k, v in parallel.slab_rows(agreement_batch(), mesh).items()}
    train_step = make_train_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    scalars = train_step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    record = step_record(scalars, state.model)
    record["params"] = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    res["train"] = dict(record=record, launches=ops.launch_counts(), rows=rows_launched(ops), ms=ms)
    del state
    # (b)
    model = seeded_model(PRESETS["us3d_stage2"], seed=0, mesh=mesh).to(device, PATH_DTYPE)
    left, right = (row_slab(t, mesh).to(device, PATH_DTYPE) for t in stereo_pair(1024, 8, 0))
    rec = eval_records(model, left, right)
    ops.reset_launch_counts()
    times = []
    for _ in range(SPACE_TIMED):
        t0 = time.perf_counter()
        model(left, right)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    res["eval"] = dict(records=rec, ms=times, launches=ops.launch_counts(), rows=rows_launched(ops))
    del model
    model = seeded_model(every_plane(PRESETS["us3d_stage2"]), seed=0, mesh=mesh).to(device)
    left, right = (row_slab(t, mesh).to(device) for t in stereo_pair(1024, 8, 0))
    res["eval_fp32_1024"] = model(left, right)["disp"][0].cpu()
    del model
    model = seeded_model(agreement_cfg().model, seed=0, mesh=mesh).to(device)
    left, right = (row_slab(t, mesh).to(device) for t in stereo_pair(256, 5, seed=1))
    res["eval_fp32"] = model(left, right)["disp"][0].cpu()
    del model
    res["train_1024"] = train_1024_step(ops, device, mesh)
    # (c)
    res["cli"] = recorded_cli_train(ops, cli_argv)
    torch.save(res, out_path)
    torch.distributed.destroy_process_group()


def recorded_cli_train(ops, cli_argv: list[str]) -> dict:
    """``cli.train.main(cli_argv)`` in this process's group, with the first
    train batch it moved to the card, the launches of every step, the
    epochs and the rows it loaded."""
    from semstereo_tpu_torch.cli import train as cli_train
    from semstereo_tpu_torch.train import trainer as trainer_mod

    steps, first = [], {}
    device_batch = trainer_mod._device_batch

    def recording(batch, keys, dev, mesh=None):
        out = device_batch(batch, keys, dev, mesh)
        if "disparity_4" in out and not first:
            first.update({k: v.cpu() for k, v in out.items()})
        return out

    trainer_mod._device_batch = recording
    try:
        with instrumented_steps(ops, steps):
            trainer = cli_train.main(cli_argv)
    finally:
        trainer_mod._device_batch = device_batch
    loader = trainer.train_loader
    return dict(steps=steps, history=trainer.history, rows=loader._indices().tolist(),
                shard=(loader.shard_index, loader.shard_count), first_batch=first)


def split_references() -> dict:
    """One process's results that the space and disp x space phases hold
    their splits to: the fp32 256x256 agreement step (``want``), the
    flagship bf16 request's records (``one``), the same request in fp32
    (the bf16 level) and in fp32 with every /4 plane kept (the splits' fp32
    witness at the flagship's size), and the fp32 256x256 request."""
    from semstereo_tpu_torch.config import PRESETS
    from semstereo_tpu_torch.train import init_state, make_train_step

    cfg = agreement_cfg()
    state = init_state(cfg)
    refs = dict(want=step_record(make_train_step(cfg)(
        state, {k: v.cuda() for k, v in agreement_batch().items()}), state.model))
    del state
    pair = stereo_pair(1024, 8, 0)
    model = seeded_model(PRESETS["us3d_stage2"], seed=0).to("cuda", PATH_DTYPE)
    refs["one"] = eval_records(model, *(t.to("cuda", PATH_DTYPE) for t in pair))
    refs["one_fp32_1024"] = model.float()(*(t.cuda() for t in pair))["disp"][0].cpu()
    del model
    model = seeded_model(every_plane(PRESETS["us3d_stage2"]), seed=0).cuda()
    refs["one_fp32_1024_every"] = model(*(t.cuda() for t in pair))["disp"][0].cpu()
    del model
    model = seeded_model(cfg.model, seed=0).cuda()
    left, right = stereo_pair(256, 5, seed=1)
    refs["one_fp32"] = model(left.cuda(), right.cuda())["disp"][0].cpu()
    return refs


def space4_worker(out_path: str) -> None:
    """One of the four processes of the space phase's (d), gloo on CUDA
    tensors: the flagship request in fp32 with every /4 plane kept, and the
    train path's step, on 256 of the 1024 rows."""
    from semstereo_tpu_torch import ops, parallel
    from semstereo_tpu_torch.config import PRESETS

    device = parallel.init_process_group("cuda", backend="gloo")
    mesh = parallel.make_mesh(-1, 1, SPACE4)
    model = seeded_model(every_plane(PRESETS["us3d_stage2"]), seed=0, mesh=mesh).to(device)
    left, right = (row_slab(t, mesh).to(device) for t in stereo_pair(1024, 8, 0))
    res = {"eval_fp32_1024": model(left, right)["disp"][0].cpu()}
    del model
    res["train_1024"] = train_1024_step(ops, device, mesh)
    torch.save(res, out_path)
    torch.distributed.destroy_process_group()


def run_space_parallel(ops, tmp: str, path: dict, train: dict, refs: dict) -> dict:
    """The space-parallel phase (docstring, item 13): the two processes,
    then the four of space 4, against the one-process ``refs``
    (``split_references``).  The one-process epoch of (c) is the trainer
    phase's stage 2 in ``tmp/stage2``; the one-process peak memory of the
    eval and of the train step are the path phases'."""
    from semstereo_tpu_torch.cli import train as cli_train
    from semstereo_tpu_torch.parallel import Mesh
    from semstereo_tpu_torch.train import checkpoint as ckpt
    from semstereo_tpu_torch.train import init_state
    from semstereo_tpu_torch.train.trainer import Trainer

    script = os.path.abspath(__file__)
    want, one, one_fp32 = refs["want"], refs["one"], refs["one_fp32"]
    one_fp32_1024, one_fp32_1024_every = refs["one_fp32_1024"], refs["one_fp32_1024_every"]
    root = f"{tmp}/data"
    cli_argv = ["--preset", "us3d_stage2", "--datapath", root, "--trainlist",
                f"{root}/train.txt", "--testlist", f"{root}/test.txt", "--loadckpt",
                f"{tmp}/stage1", "--epochs", "1", "--save-freq", "1", "--compute-dtype",
                "bfloat16", "--batch-size", str(TRAIN_BATCH), "--test-batch-size",
                str(TRAIN_BATCH), "--num-workers", str(TRAINER_WORKERS), "--device", "cuda",
                "--logdir", f"{tmp}/space_run", "--space-parallel", str(SPACE)]
    port = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "WORLD_SIZE": str(SPACE)}
    t0 = time.perf_counter()
    spawn([([script, "--worker", "space", f"{tmp}/space{r}.pt", *cli_argv],
            dict(port, RANK=str(r), LOCAL_RANK="0")) for r in range(SPACE)], DP_TIMEOUT)
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/space{r}.pt", weights_only=False) for r in range(SPACE)]
    meshes = [Mesh(data=1, disp=1, space=SPACE, space_index=r) for r in range(SPACE)]
    failures = []
    # (a)
    tr = [r["train"] for r in ranks]
    agreement, ok = step_agreement(tr[0]["record"], want)
    equal = all(torch.equal(tr[0]["record"][part][n], t) for part in ("grads", "params")
                for n, t in tr[1]["record"][part].items())
    res = {"wall_s": wall, "train": dict(
        size=256, dtype="float32", global_batch=2, ms_per_step=[t["ms"] for t in tr],
        launches=[t["launches"] for t in tr], rows=[t["rows"] for t in tr], ranks_equal=equal,
        **agreement)}
    if not ok:
        failures.append("the space=2 step disagrees with the one-process step")
    if not equal:
        failures.append("the two processes' gradients or parameters differ")
    if any(t["launches"] != TRAIN_LAUNCHES or t["rows"] != {"K2": 16, "K4": 16} for t in tr):
        failures.append("space=2 train launches or rows")
    # (b)
    ev = [r["eval"] for r in ranks]
    got = {k: torch.cat([e["records"][k] for e in ev], dim=1 if k in ("label", "disp") else 2)
           for k in ("label", "disp", "att", "cost", "samples")}
    same = (got["samples"] == one["samples"]).all(dim=1)  # [B, H4, W4]
    cost_diff = (got["cost"] - one["cost"]).abs().amax(dim=1)[same]
    disp_diff = (got["disp"] - one["disp"]).abs()
    fp32 = (torch.cat([r["eval_fp32"] for r in ranks], 1).double() - one_fp32.double()).abs()
    fp32 = fp32[:, :, 32:]
    fp32_1024 = (torch.cat([r["eval_fp32_1024"] for r in ranks], 1).double()
                 - one_fp32_1024_every.double()).abs()[:, :, 32:]
    bf16_split = float((got["disp"].double() - one["disp"].double()).abs()[:, :, 32:].median())
    bf16_level = float((one["disp"].double() - one_fp32_1024.double()).abs()[:, :, 32:].median())
    bands = boundary_bands(same, same.shape[1] // SPACE, SPACE_BAND_ROWS)
    per_request = [{k: v // SPACE_TIMED for k, v in e["launches"].items()} for e in ev]
    t1024 = [r["train_1024"] for r in ranks]
    res["eval"] = dict(
        size=1024, dtype="bfloat16", note="two processes share one card; gloo stages the "
        "halos and reductions through the host", ms_per_pair=[e["ms"] for e in ev],
        ms_per_pair_median=[statistics.median(e["ms"]) for e in ev], launches=per_request,
        rows_per_request=[{k: v // SPACE_TIMED for k, v in e["rows"].items()} for e in ev],
        label_max_rel=max_rel(got["label"], one["label"]),
        att_max_rel=max_rel(got["att"], one["att"]),
        cost_max_rel_same_topk=float(cost_diff.max() / one["cost"].abs().max()),
        label_argmax_equal=float((got["label"].argmax(-1) == one["label"].argmax(-1))
                                 .double().mean()),
        same_topk_share=float(same.double().mean()),
        disp_median_abs_px=float(disp_diff.median()),
        disp_max_abs_px_same_topk=float(disp_diff[same.repeat_interleave(4, 1)
                                                  .repeat_interleave(4, 2)].max()),
        peak_bytes=[e["records"]["peak_bytes"] for e in ev], one_process_peak_bytes=one[
            "peak_bytes"], one_process_path_peak_bytes=path["max_memory_allocated_bytes"],
        fp32_256=dict(median=float(fp32.median()), max=float(fp32.max())),
        fp32_1024_every_plane=dict(median=float(fp32_1024.median()),
                                   max=float(fp32_1024.max())),
        disp_median_abs_px_cols32=bf16_split, one_process_bf16_vs_fp32_median_px=bf16_level,
        topk_differs_by_band=bands)
    res["train_1024"] = dict(
        size=1024, batch=TRAIN_BATCH, dtype="bfloat16", ms=[t["ms"] for t in t1024],
        peak_bytes=[t["peak_bytes"] for t in t1024],
        one_process_peak_bytes=train["max_memory_allocated_bytes"],
        launches=[t["launches"] for t in t1024], rows=[t["rows"] for t in t1024],
        loss=[t["loss"] for t in t1024])
    e = res["eval"]
    if not (max(e["label_max_rel"], e["att_max_rel"]) <= BF16_REL
            and e["cost_max_rel_same_topk"] <= SPACE_COST_REL
            and e["same_topk_share"] >= SPACE_SAME_TOPK):
        failures.append("the space=2 eval disagrees with the one-process run")
    if any(p != EVAL_LAUNCHES for p in per_request) or any(
            r != {"K2": 64, "K4": 0} for r in e["rows_per_request"]):
        failures.append("space=2 eval launches or rows")
    if not (fp32.median() <= FUSE_FP32_BOUNDS["median"] and fp32.max() <= FUSE_FP32_BOUNDS["max"]):
        failures.append("the space=2 fp32 eval's disparity disagrees with one process's")
    if not (fp32_1024.median() <= FUSE_FP32_BOUNDS["median"]
            and fp32_1024.max() <= FUSE_FP32_BOUNDS["max"]):
        failures.append("the space=2 fp32 1024x1024 eval's disparity disagrees with one "
                        "process's")
    if not bf16_split <= SPACE_BF16_LEVEL * bf16_level:
        failures.append(f"the space=2 bf16 disparity is {bf16_split} px from one process's "
                        f"(median), beyond {SPACE_BF16_LEVEL} x the bf16 level {bf16_level}")
    if not bands["boundary"] <= bands["others_median"] + SPACE_BAND_EXCESS:
        failures.append(f"the top-k choices differ from one process's in {bands['boundary']} "
                        f"of the slab boundary's band, against {bands['others_median']} "
                        "elsewhere")
    if any(t["launches"] != TRAIN_LAUNCHES or t["rows"] != {"K2": 64, "K4": 64}
           or not np.isfinite(t["loss"]) for t in t1024):
        failures.append("the space=2 1024x1024 train step's launches, rows or loss")
    # (c)
    space_run = f"{tmp}/space_run"
    sd = [torch.load(f"{tmp}/{run}/checkpoint_000000.pt", weights_only=True)["model"]
          for run in ("stage2", "space_run")]
    moved = torch.cat([(sd[1][n] - p).abs().ravel() for n, p in sd[0].items()
                       if "running_" not in n]) / agreement_cfg().optim.lr
    cli = [r["cli"] for r in ranks]
    logs = []
    for run in ("stage2", "space_run"):
        with open(f"{tmp}/{run}/log.log") as f:
            logs.append(f.read())
    first_loss = [float(re.search(r"Epoch 0/1, Iter 0/\d+, loss = (\S+),", text).group(1))
                  for text in logs]
    # one process's eval of the space run's checkpoint, and its first batch
    one_cfg, _ = cli_train.parse_config(cli_argv[:cli_argv.index("--space-parallel")])
    trainer = Trainer(one_cfg, device="cuda")
    trainer.state = ckpt.restore_checkpoint(space_run, init_state(one_cfg))
    want_eval = trainer.evaluate()
    trainer.train_loader.set_epoch(0)
    want_rows = trainer.train_loader._indices().tolist()
    want_batch = next(iter(trainer.train_loader))
    del trainer
    batch_equal = all(
        set(c["first_batch"]) == {"left", "right", "disparity", "disparity_4", "label"}
        and all(torch.equal(v, row_slab(torch.from_numpy(np.asarray(want_batch[k])), m))
                for k, v in c["first_batch"].items())
        for c, m in zip(cli, meshes))
    eval_rel = {k: max(abs(c["history"][-1]["eval"].get(k, np.inf) - v) / max(abs(v), 1.0)
                    for c in cli)
                for k, v in want_eval.items()}
    res["cli"] = dict(
        ms_per_step=[[ms for kind, ms, _ in c["steps"] if kind == "train"] for c in cli],
        param_diff_over_lr_max=float(moved.max()), param_diff_over_lr_median=float(moved.median()),
        steps=[ln for ln in logs[1].splitlines() if ln.startswith("Epoch 0/1, Iter")],
        one_steps=[ln for ln in logs[0].splitlines() if ln.startswith("Epoch 0/1, Iter")],
        first_loss_rel=abs(first_loss[1] - first_loss[0]) / abs(first_loss[0]),
        first_batch_equal=batch_equal, eval=cli[0]["history"][-1]["eval"],
        one_process_eval_of_checkpoint=want_eval, eval_rel=eval_rel,
        eval_rel_max=max(eval_rel.values()), one_epoch_eval=logged_eval(logs[0]))
    for c in cli:
        for kind, want_l in (("train", TRAIN_LAUNCHES), ("eval", EVAL_LAUNCHES)):
            got_l = [l for k, _, l in c["steps"] if k == kind]
            if not got_l or any(l != want_l for l in got_l):
                failures.append(f"space=2 CLI {kind} launches {got_l}")
    if any(c["rows"] != want_rows or c["shard"] != (0, 1) for c in cli) or not batch_equal:
        failures.append(f"space=2 CLI rows {[(c['shard'], c['rows']) for c in cli]}, one "
                        f"process's {want_rows}; first batch cut by height equal: {batch_equal}")
    if sd[0].keys() != sd[1].keys():
        failures.append("the space=2 CLI checkpoint's leaves differ from one process's")
    if not res["cli"]["first_loss_rel"] <= SPACE_CLI_LOSS_REL:
        failures.append(f"the space=2 CLI first loss {first_loss[1]} against {first_loss[0]}")
    if any(set(c["history"][-1]["eval"]) != set(want_eval) for c in cli) or not all(
            np.isfinite(v) and v <= SPACE_CLI_EVAL_REL for v in eval_rel.values()):
        failures.append(f"the space=2 CLI eval against one process's of its checkpoint: "
                        f"{eval_rel}")
    # (d): space 4
    port = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "WORLD_SIZE": str(SPACE4)}
    t0 = time.perf_counter()
    spawn([([script, "--worker", "space4", f"{tmp}/space4_{r}.pt"],
            dict(port, RANK=str(r), LOCAL_RANK="0")) for r in range(SPACE4)], DP_TIMEOUT)
    s4 = [torch.load(f"{tmp}/space4_{r}.pt", weights_only=False) for r in range(SPACE4)]
    fp32_s4 = (torch.cat([r["eval_fp32_1024"] for r in s4], 1).double()
               - one_fp32_1024_every.double()).abs()[:, :, 32:]
    t4 = [r["train_1024"] for r in s4]
    res["space4"] = dict(
        wall_s=time.perf_counter() - t0, size=1024,
        fp32_1024_every_plane=dict(median=float(fp32_s4.median()), max=float(fp32_s4.max())),
        train_1024=dict(batch=TRAIN_BATCH, dtype="bfloat16", ms=[t["ms"] for t in t4],
                        peak_bytes=[t["peak_bytes"] for t in t4],
                        space2_peak_bytes=res["train_1024"]["peak_bytes"],
                        one_process_peak_bytes=train["max_memory_allocated_bytes"],
                        launches=[t["launches"] for t in t4], rows=[t["rows"] for t in t4],
                        loss=[t["loss"] for t in t4]))
    if not (fp32_s4.median() <= FUSE_FP32_BOUNDS["median"]
            and fp32_s4.max() <= FUSE_FP32_BOUNDS["max"]):
        failures.append("the space=4 fp32 1024x1024 eval's disparity disagrees with one "
                        "process's")
    if any(t["launches"] != TRAIN_LAUNCHES or t["rows"] != {"K2": 32, "K4": 32}
           or not np.isfinite(t["loss"]) for t in t4):
        failures.append("the space=4 1024x1024 train step's launches, rows or loss")
    log("space_parallel", json.dumps(res))
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def split_step(ops, cfg, mesh, device) -> dict:
    """The fp32 256x256 agreement step under ``cfg``'s split on this
    process's rows of the agreement batch (its data shard's, cut to its row
    slab): the step's record (process 0's), its launches, K2's and K4's
    planes and rows, its ms, and whether every process holds process 0's
    gradients and parameters bit for bit."""
    from semstereo_tpu_torch import parallel
    from semstereo_tpu_torch.train import init_state, make_train_step

    state = init_state(cfg, device=device, mesh=mesh)
    rows = {k: v[mesh.data_index::mesh.data] for k, v in agreement_batch().items()}
    batch = {k: v.to(device) for k, v in parallel.slab_rows(rows, mesh).items()}
    train_step = make_train_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    scalars = train_step(state, batch)
    torch.cuda.synchronize()
    res = dict(ms=1e3 * (time.perf_counter() - t0), launches=ops.launch_counts(),
               planes=planes(ops), rows=rows_launched(ops))
    params = list(state.model.parameters())
    try:
        parallel.broadcast_check([*(p.grad for p in params), *params],
                                 "gradients or parameters")
        res["ranks_equal"] = True
    except RuntimeError:
        res["ranks_equal"] = False
    if parallel.process_index() == 0:
        res["record"] = step_record(scalars, state.model)
    return res


def disp_space_worker(out_path: str, cli_argv: list[str]) -> None:
    """One of the four processes of the disp x space phase (docstring, item
    14), gloo on CUDA tensors."""
    from semstereo_tpu_torch import ops, parallel
    from semstereo_tpu_torch.cli import evaluate as cli_evaluate
    from semstereo_tpu_torch.config import PRESETS, ParallelConfig

    device = parallel.init_process_group("cuda", backend="gloo")
    mesh = parallel.make_mesh(-1, DISP, SPACE)
    # (a)
    res = {"train": split_step(ops, agreement_cfg().replace(
        parallel=ParallelConfig(disp=DISP, space=SPACE)), mesh, device)}
    # (b)
    model = seeded_model(PRESETS["us3d_stage2"], seed=0, mesh=mesh).to(device, PATH_DTYPE)
    left, right = (row_slab(t, mesh).to(device, PATH_DTYPE) for t in stereo_pair(1024, 8, 0))
    rec = eval_records(model, left, right)
    ops.reset_launch_counts()
    times = []
    for _ in range(SPACE_TIMED):
        t0 = time.perf_counter()
        model(left, right)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    res["eval"] = dict(records=rec, ms=times, launches=ops.launch_counts(), rows=rows_launched(ops),
                       planes=planes(ops))
    del model
    model = seeded_model(every_plane(PRESETS["us3d_stage2"]), seed=0, mesh=mesh).to(device)
    left, right = (row_slab(t, mesh).to(device) for t in stereo_pair(1024, 8, 0))
    torch.backends.cudnn.deterministic = True
    res["eval_fp32_1024"] = model(left, right)["disp"][0].cpu()
    torch.backends.cudnn.deterministic = False
    del model
    # (d)
    res["train_1024"] = train_1024_step(ops, device, mesh)
    # (c): cli.train, then cli.evaluate of the run's checkpoint
    res["cli"] = recorded_cli_train(ops, cli_argv)
    eval_steps = []
    with instrumented_steps(ops, eval_steps):
        res["evaluate"] = dict(results=cli_evaluate.main(evaluate_argv(cli_argv)),
                               steps=eval_steps)
    torch.save(res, out_path)
    torch.distributed.destroy_process_group()


def dds_step_worker(out_path: str) -> None:
    """One of the eight processes of the disp x space phase's (e), gloo on
    CUDA tensors: the agreement step at data 2 x disp 2 x space 2."""
    from semstereo_tpu_torch import ops, parallel
    from semstereo_tpu_torch.config import ParallelConfig

    device = parallel.init_process_group("cuda", backend="gloo")
    mesh = parallel.make_mesh(2, DISP, SPACE)
    res = split_step(ops, agreement_cfg().replace(
        parallel=ParallelConfig(data=2, disp=DISP, space=SPACE)), mesh, device)
    torch.save(res, out_path)
    torch.distributed.destroy_process_group()


def evaluate_argv(cli_argv: list[str]) -> list[str]:
    """``cli.evaluate``'s arguments for the checkpoint of the ``cli.train``
    run of ``cli_argv``: its test list, test batch, device and parallel
    flags."""
    keep = ("--preset", "--datapath", "--testlist", "--device", "--disp-parallel",
            "--space-parallel")
    argv = []
    for flag in keep:
        if flag in cli_argv:
            argv += [flag, cli_argv[cli_argv.index(flag) + 1]]
    return [*argv, "--batch-size", cli_argv[cli_argv.index("--test-batch-size") + 1],
            "--loadckpt", cli_argv[cli_argv.index("--logdir") + 1]]


def topk_membership(samples: torch.Tensor, planes: int) -> torch.Tensor:
    """[B, planes, H, W]: whether each /4 plane is among a pixel's top-k
    choice (``samples`` [B, k, H, W], the symmetric range's disparities)."""
    ind = (samples + planes // 2).long().movedim(1, -1)
    return torch.nn.functional.one_hot(ind, planes).sum(-2).movedim(-1, 1) > 0


def run_disp_space_parallel(ops, tmp: str, train: dict, refs: dict, space: dict) -> dict:
    """The disp x space phase (docstring, item 14): the four processes of
    disp 2 x space 2, then the eight of data 2 x disp 2 x space 2, against
    the one-process ``refs`` (``split_references``).  The one-process
    epoch of (c) is the trainer phase's stage 2 in ``tmp/stage2``; the
    peak memory of the train step is held beside the train path's and the
    space phase's."""
    from semstereo_tpu_torch.cli import evaluate as cli_evaluate
    from semstereo_tpu_torch.cli import train as cli_train
    from semstereo_tpu_torch.parallel import Mesh
    from semstereo_tpu_torch.train import checkpoint as ckpt
    from semstereo_tpu_torch.train import init_state
    from semstereo_tpu_torch.train.trainer import Trainer

    script = os.path.abspath(__file__)
    want, one = refs["want"], refs["one"]
    world = DISP * SPACE
    root = f"{tmp}/data"
    cli_argv = ["--preset", "us3d_stage2", "--datapath", root, "--trainlist",
                f"{root}/train.txt", "--testlist", f"{root}/test.txt", "--loadckpt",
                f"{tmp}/stage1", "--epochs", "1", "--save-freq", "1", "--compute-dtype",
                "bfloat16", "--batch-size", str(TRAIN_BATCH), "--test-batch-size",
                str(TRAIN_BATCH), "--num-workers", str(TRAINER_WORKERS), "--device", "cuda",
                "--logdir", f"{tmp}/disp_space_run", "--disp-parallel", str(DISP),
                "--space-parallel", str(SPACE)]
    port = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "WORLD_SIZE": str(world)}
    t0 = time.perf_counter()
    spawn([([script, "--worker", "disp-space", f"{tmp}/disp_space{r}.pt", *cli_argv],
            dict(port, RANK=str(r), LOCAL_RANK="0")) for r in range(world)], DP_TIMEOUT)
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/disp_space{r}.pt", weights_only=False) for r in range(world)]
    # rank = disp_index * space + space_index; the first SPACE hold disp index 0
    meshes = [Mesh(data=1, disp=DISP, space=SPACE, disp_index=r // SPACE, space_index=r % SPACE)
              for r in range(world)]
    failures = []
    d8, r8 = 16, 32  # the agreement step's /8 planes and rows
    # (a)
    tr = [r["train"] for r in ranks]
    agreement, ok = step_agreement(tr[0]["record"], want)
    res = {"wall_s": wall, "train": dict(
        size=256, dtype="float32", global_batch=2, ms_per_step=[t["ms"] for t in tr],
        launches=[t["launches"] for t in tr], planes=[t["planes"] for t in tr],
        rows=[t["rows"] for t in tr], ranks_equal=all(t["ranks_equal"] for t in tr),
        **agreement)}
    if not ok:
        failures.append("the disp=2 x space=2 step disagrees with the one-process step")
    if not res["train"]["ranks_equal"]:
        failures.append("the disp=2 x space=2 processes' gradients or parameters differ")
    slab = {"K2": d8 // DISP, "K4": d8 // DISP}, {"K2": r8 // SPACE, "K4": r8 // SPACE}
    if any(t["launches"] != TRAIN_LAUNCHES or (t["planes"], t["rows"]) != slab for t in tr):
        failures.append("disp=2 x space=2 train launches, planes or rows")
    # (b)
    ev = [r["eval"] for r in ranks]
    keys = ("label", "disp", "att", "cost", "samples")
    got = {k: torch.cat([e["records"][k] for e in ev[:SPACE]],
                        dim=1 if k in ("label", "disp") else 2) for k in keys}
    ranks_equal = all(torch.equal(ev[s]["records"][k], ev[p * SPACE + s]["records"][k])
                      for p in range(1, DISP) for s in range(SPACE) for k in keys)
    same = (got["samples"] == one["samples"]).all(dim=1)  # [B, H4, W4]
    cost_diff = (got["cost"] - one["cost"]).abs().amax(dim=1)[same]
    disp_diff = (got["disp"] - one["disp"]).abs()
    # every process's rows in fp32 (each disp group's processes hold the
    # same rows), against one process's
    fp32_1024 = torch.stack([
        (torch.cat([r["eval_fp32_1024"] for r in ranks[p * SPACE:(p + 1) * SPACE]], 1).double()
         - refs["one_fp32_1024_every"].double()).abs()[:, :, 32:] for p in range(DISP)])
    fp32_group = max(float((ranks[s]["eval_fp32_1024"] - ranks[p * SPACE + s]["eval_fp32_1024"])
                           .abs().max()) for p in range(1, DISP) for s in range(SPACE))
    bf16_split = float(disp_diff[:, :, 32:].double().median())
    bf16_level = float((one["disp"].double() - refs["one_fp32_1024"].double())
                       .abs()[:, :, 32:].median())
    d4 = one["att"].shape[1] * 2  # /4 planes: the /8 volume's, resized x2
    row_bands = boundary_bands(same, same.shape[1] // SPACE, SPACE_BAND_ROWS)
    plane_same = topk_membership(got["samples"], d4) == topk_membership(one["samples"], d4)
    plane_bands = boundary_bands(plane_same, d4 // DISP, DISP_SPACE_PLANE_BAND)
    per_request = [{k: v // SPACE_TIMED for k, v in e["launches"].items()} for e in ev]
    slabs = [({k: v // SPACE_TIMED for k, v in e["planes"].items()},
              {k: v // SPACE_TIMED for k, v in e["rows"].items()}) for e in ev]
    res["eval"] = dict(
        size=1024, dtype="bfloat16", note="four processes share one card; gloo stages the "
        "halos, gathers and reductions through the host: no speed of the split",
        ms_per_pair=[e["ms"] for e in ev],
        ms_per_pair_median=[statistics.median(e["ms"]) for e in ev], launches=per_request,
        planes_rows_per_request=slabs, ranks_equal=ranks_equal,
        label_max_rel=max_rel(got["label"], one["label"]),
        att_max_rel=max_rel(got["att"], one["att"]),
        cost_max_rel_same_topk=float(cost_diff.max() / one["cost"].abs().max())
        if same.any() else float("inf"),
        same_topk_share=float(same.double().mean()),
        disp_median_abs_px=float(disp_diff.median()),
        peak_bytes=[e["records"]["peak_bytes"] for e in ev],
        one_process_peak_bytes=one["peak_bytes"],
        fp32_1024_every_plane=dict(median=float(fp32_1024.median()),
                                   max=float(fp32_1024.max()),
                                   disp_group_max_abs_px=fp32_group),
        disp_median_abs_px_cols32=bf16_split, one_process_bf16_vs_fp32_median_px=bf16_level,
        topk_differs_by_row_band=row_bands, topk_membership_differs_by_plane_band=plane_bands)
    e = res["eval"]
    if not (max(e["label_max_rel"], e["att_max_rel"]) <= BF16_REL
            and e["cost_max_rel_same_topk"] <= SPACE_COST_REL
            and e["same_topk_share"] >= SPACE_SAME_TOPK and ranks_equal):
        failures.append("the disp=2 x space=2 eval disagrees with the one-process run")
    if any(p != EVAL_LAUNCHES for p in per_request) or any(
            sl != ({"K2": 16 // DISP, "K4": 0}, {"K2": 128 // SPACE, "K4": 0}) for sl in slabs):
        failures.append("disp=2 x space=2 eval launches, planes or rows")
    if not (fp32_1024.median() <= FUSE_FP32_BOUNDS["median"]
            and fp32_1024.max() <= FUSE_FP32_BOUNDS["max"] and fp32_group == 0):
        failures.append("the disp=2 x space=2 fp32 1024x1024 eval's disparity disagrees with "
                        "one process's, or within a disp group")
    if not bf16_split <= SPACE_BF16_LEVEL * bf16_level:
        failures.append(f"the disp=2 x space=2 bf16 disparity is {bf16_split} px from one "
                        f"process's (median), beyond {SPACE_BF16_LEVEL} x the bf16 level "
                        f"{bf16_level}")
    for name, bands in (("row", row_bands), ("plane", plane_bands)):
        if not bands["boundary"] <= bands["others_median"] + SPACE_BAND_EXCESS:
            failures.append(f"the top-k choices differ from one process's in "
                            f"{bands['boundary']} of the {name} slab boundary's band, against "
                            f"{bands['others_median']} elsewhere")
    # (d)
    t1024 = [r["train_1024"] for r in ranks]
    res["train_1024"] = dict(
        size=1024, batch=TRAIN_BATCH, dtype="bfloat16", ms=[t["ms"] for t in t1024],
        peak_bytes=[t["peak_bytes"] for t in t1024],
        one_process_peak_bytes=train["max_memory_allocated_bytes"],
        space2_peak_bytes=space["train_1024"]["peak_bytes"],
        space4_peak_bytes=space["space4"]["train_1024"]["peak_bytes"],
        launches=[t["launches"] for t in t1024], planes=[t["planes"] for t in t1024],
        rows=[t["rows"] for t in t1024], loss=[t["loss"] for t in t1024])
    if any(t["launches"] != TRAIN_LAUNCHES or t["planes"] != {"K2": 8, "K4": 8}
           or t["rows"] != {"K2": 64, "K4": 64} or not np.isfinite(t["loss"]) for t in t1024):
        failures.append("the disp=2 x space=2 1024x1024 train step's launches, planes, rows "
                        "or loss")
    # (c)
    run = f"{tmp}/disp_space_run"
    sd = [torch.load(f"{tmp}/{r}/checkpoint_000000.pt", weights_only=True)["model"]
          for r in ("stage2", "disp_space_run")]
    moved = torch.cat([(sd[1][n] - p).abs().ravel() for n, p in sd[0].items()
                       if "running_" not in n]) / agreement_cfg().optim.lr
    cli = [r["cli"] for r in ranks]
    logs = []
    for r in ("stage2", "disp_space_run"):
        with open(f"{tmp}/{r}/log.log") as f:
            logs.append(f.read())
    first_loss = [float(re.search(r"Epoch 0/1, Iter 0/\d+, loss = (\S+),", text).group(1))
                  for text in logs]
    # one process's eval of the run's checkpoint (as the run evaluated, in
    # bf16, and as cli.evaluate does, in the preset's fp32), and its first batch
    one_cfg, _ = cli_train.parse_config(cli_argv[:cli_argv.index("--disp-parallel")])
    trainer = Trainer(one_cfg, device="cuda")
    trainer.state = ckpt.restore_checkpoint(run, init_state(one_cfg))
    want_eval = trainer.evaluate()
    trainer.train_loader.set_epoch(0)
    want_rows = trainer.train_loader._indices().tolist()
    want_batch = next(iter(trainer.train_loader))
    del trainer
    eval_argv = evaluate_argv(cli_argv)
    want_evaluate = cli_evaluate.main(eval_argv[:eval_argv.index("--disp-parallel")]
                                      + eval_argv[eval_argv.index("--batch-size"):])
    batch_equal = all(
        set(c["first_batch"]) == {"left", "right", "disparity", "disparity_4", "label"}
        and all(torch.equal(v, row_slab(torch.from_numpy(np.asarray(want_batch[k])), m))
                for k, v in c["first_batch"].items())
        for c, m in zip(cli, meshes))

    def rel(results, reference):
        return {k: max(abs(r.get(k, np.inf) - v) / max(abs(v), 1.0) for r in results)
                for k, v in reference.items()}

    eval_rel = rel([c["history"][-1]["eval"] for c in cli], want_eval)
    evaluate_rel = rel([r["evaluate"]["results"] for r in ranks], want_evaluate)
    res["cli"] = dict(
        ms_per_step=[[ms for kind, ms, _ in c["steps"] if kind == "train"] for c in cli],
        param_diff_over_lr_max=float(moved.max()), param_diff_over_lr_median=float(moved.median()),
        steps=[ln for ln in logs[1].splitlines() if ln.startswith("Epoch 0/1, Iter")],
        one_steps=[ln for ln in logs[0].splitlines() if ln.startswith("Epoch 0/1, Iter")],
        first_loss_rel=abs(first_loss[1] - first_loss[0]) / abs(first_loss[0]),
        first_batch_equal=batch_equal, eval=cli[0]["history"][-1]["eval"],
        one_process_eval_of_checkpoint=want_eval, eval_rel_max=max(eval_rel.values()),
        evaluate=ranks[0]["evaluate"]["results"], one_process_evaluate=want_evaluate,
        evaluate_rel_max=max(evaluate_rel.values()))
    for i, r in enumerate(ranks):
        for kind, want_l, steps in (("train", TRAIN_LAUNCHES, r["cli"]["steps"]),
                                    ("eval", EVAL_LAUNCHES, r["cli"]["steps"]),
                                    ("eval", EVAL_LAUNCHES, r["evaluate"]["steps"])):
            got_l = [l for k, _, l in steps if k == kind]
            if not got_l or any(l != want_l for l in got_l):
                failures.append(f"disp=2 x space=2 CLI rank {i} {kind} launches {got_l}")
    if any(c["rows"] != want_rows or c["shard"] != (0, 1) for c in cli) or not batch_equal:
        failures.append(f"disp=2 x space=2 CLI rows {[(c['shard'], c['rows']) for c in cli]}, "
                        f"one process's {want_rows}; first batch cut by height equal: "
                        f"{batch_equal}")
    if sd[0].keys() != sd[1].keys():
        failures.append("the disp=2 x space=2 CLI checkpoint's leaves differ from one process's")
    if not res["cli"]["first_loss_rel"] <= DISP_CLI_LOSS_REL:
        failures.append(f"the disp=2 x space=2 CLI first loss {first_loss[1]} against "
                        f"{first_loss[0]}")
    for name, got_rel in (("eval epoch", eval_rel), ("cli.evaluate", evaluate_rel)):
        if not all(np.isfinite(v) and v <= SPACE_CLI_EVAL_REL for v in got_rel.values()):
            failures.append(f"the disp=2 x space=2 {name} against one process's of its "
                            f"checkpoint: {got_rel}")
    # (e)
    world8 = 2 * DISP * SPACE
    port = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "WORLD_SIZE": str(world8)}
    t0 = time.perf_counter()
    spawn([([script, "--worker", "dds-step", f"{tmp}/dds{r}.pt"],
            dict(port, RANK=str(r), LOCAL_RANK="0")) for r in range(world8)], DP_TIMEOUT)
    dds = [torch.load(f"{tmp}/dds{r}.pt", weights_only=False) for r in range(world8)]
    agreement, ok = step_agreement(dds[0]["record"], want)
    res["data2_disp2_space2"] = dict(
        wall_s=time.perf_counter() - t0, size=256, dtype="float32", global_batch=2,
        ms_per_step=[t["ms"] for t in dds], launches=[t["launches"] for t in dds],
        planes=[t["planes"] for t in dds], rows=[t["rows"] for t in dds],
        ranks_equal=all(t["ranks_equal"] for t in dds), **agreement)
    if not ok or not res["data2_disp2_space2"]["ranks_equal"]:
        failures.append("the data=2 x disp=2 x space=2 step disagrees with the one-process step "
                        "or between its processes")
    if any(t["launches"] != TRAIN_LAUNCHES or (t["planes"], t["rows"]) != slab for t in dds):
        failures.append("data=2 x disp=2 x space=2 train launches, planes or rows")
    log("disp_space_parallel", json.dumps(res))
    if failures:
        raise AssertionError("; ".join(failures))
    return res


@contextlib.contextmanager
def held_against_plain(records: list):
    """Within the block, every call of K1 (``conv3d_bn_act``), K3's dw, K2
    and K4 also runs its plain version on the same inputs and appends
    (kernel, input shape, max |kernel - plain| / max |plain|) to
    ``records``; the launch counts are left as they were."""
    from semstereo_tpu_torch.ops import conv3d as c3
    from semstereo_tpu_torch.ops import cost_volume as cv

    def dw_plain(x, gy, stride):
        return c3.conv3d_weight_grad_plain(x.float(), gy.float(), stride).to(x.dtype)

    pairs = {"K1": (c3, "conv3d_bn_act", c3.conv3d_bn_act_plain),
             "K3-dw": (c3, "conv3d_weight_grad", dw_plain),
             "K2": (cv, "gwc_volume_norm_fwd", cv.gwc_volume_norm_plain),
             "K4": (cv, "gwc_volume_norm_bwd", cv.gwc_volume_norm_bwd_plain)}
    saved = {name: getattr(mod, attr) for name, (mod, attr, _) in pairs.items()}

    def held(name, kernel, plain):
        def run(*a, **k):
            got, want = kernel(*a, **k), plain(*a, **k)
            outs = zip(*(((got,), (want,)) if isinstance(got, torch.Tensor) else (got, want)))
            records.append((name, list(a[0].shape), max(max_rel(g, w) for g, w in outs)))
            return got
        # the kernels count their launches (and planes, rows) on the name
        # they are called by
        run.__dict__.update(dict.fromkeys(vars(kernel), 0))
        return run

    for name, (mod, attr, plain) in pairs.items():
        setattr(mod, attr, held(name, saved[name], plain))
    try:
        yield records
    finally:
        for name, (mod, attr, _) in pairs.items():
            setattr(mod, attr, saved[name])


def run_bf16_curves(ops) -> dict:
    """bf16 against fp32 over many steps (docstring, item 15): each kernel
    call of one bf16 step of the tiny config against its plain version
    (``REL_TOL``), every one of the four called; then curves of
    ``convergence.BF16_STEPS`` steps over the 4 batches of 8 synthetic
    samples in order, in fp32 and in bf16 from the fp32 master of each of
    ``convergence.BF16_SEEDS`` and in fp32 again from the first seed's,
    each a process of its own in PyTorch's deterministic mode
    (``convergence.run_curves``, all at once), every step launching
    ``TRAIN_LAUNCHES`` and every loss finite; the fp32 repeat equal to the
    first seed's fp32 curve bit for bit; the first seed's tails (the mean
    of the last ``convergence.TAIL_STEPS`` losses) below
    ``BF16_CURVE_FALL`` of their first losses; and
    ``convergence.tail_verdict`` over the seeds: the median bf16 tail
    within ``convergence.TAIL_REL`` of the median fp32 tail, and every tail
    below ``convergence.FALL_TRACKS`` of its first loss."""
    from semstereo_tpu_torch import convergence
    from semstereo_tpu_torch.train import init_state, make_train_step

    failures, records = [], []
    seeds, steps = convergence.BF16_SEEDS, convergence.BF16_STEPS
    cfg = convergence.tiny_config("bfloat16", seeds[0])
    state = init_state(cfg)
    with held_against_plain(records):
        make_train_step(cfg)(state, convergence.curve_batches("cuda")[0])
    worst = {}
    for name, shape, err in records:
        key = f"{name} {shape}"
        worst[key] = max(worst.get(key, 0.0), err)
    missing = {"K1", "K3-dw", "K2", "K4"} - {name for name, _, _ in records}
    if missing:
        failures.append(f"the tiny bf16 step called no {sorted(missing)}")
    elif max(worst.values()) > REL_TOL[torch.bfloat16]:
        failures.append(f"a kernel disagrees with its plain version at the tiny step: {worst}")
    del state
    runs = [(dt, seed) for seed in seeds for dt in ("float32", "bfloat16")]
    runs.append(("float32", seeds[0]))  # the repeat
    t0 = time.perf_counter()
    curves = convergence.run_curves(runs, steps, "cuda")
    wall = time.perf_counter() - t0
    res = {"kernel_vs_plain_max_rel": worst, "seeds": list(seeds), "wall_s": wall,
           "curves": {}}
    for i, ((dt, seed), c) in enumerate(zip(runs, curves)):
        losses = c["loss"]
        kind = f"{dt}_seed{seed}" + ("_repeat" if i == len(runs) - 1 else "")
        t = convergence.tail(losses)
        res["curves"][kind] = dict(first=losses[0], last=losses[-1], tail_mean=t,
                                   fall=t / losses[0], every_20=losses[::20],
                                   tail_terms={k: convergence.tail(c[k])
                                               for k in convergence.CURVE_KEYS},
                                   s=c["s"], launches=c["launches"])
        if c["launches"] != {k: v * steps for k, v in TRAIN_LAUNCHES.items()}:
            failures.append(f"{kind} curve launches {c['launches']}")
        if not all(np.isfinite(losses)):
            failures.append(f"non-finite {kind} losses")
        elif seed == seeds[0] and t >= BF16_CURVE_FALL * losses[0]:
            failures.append(f"the {kind} curve's tail {t} is not below "
                            f"{BF16_CURVE_FALL} of its first loss {losses[0]}")
    res["fp32_repeats_bitwise"] = curves[-1]["loss"] == curves[0]["loss"]
    if not res["fp32_repeats_bitwise"]:
        failures.append("the fp32 curve does not repeat itself in deterministic mode")
    verdict = convergence.tail_verdict(
        *([c["loss"] for (dt, _), c in zip(runs[:-1], curves) if dt == want]
          for want in ("float32", "bfloat16")))
    res.update(verdict)
    for key in ("pass_bf16_tracks_fp32", "pass_both_decrease"):
        if not verdict[key]:
            failures.append(f"{key}: median tail ratio "
                            f"{verdict['median_tail_ratio_bf16_over_fp32']}, falls "
                            f"{verdict['falls']}")
    log("bf16_curves", json.dumps(res))
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def run_convergence() -> dict:
    """The convergence harness (docstring, item 16): ``python -m
    semstereo_tpu_torch.convergence --only overfit``, ``--only
    overfit_bf16`` and ``--only twostage``, three processes at once on the
    card, each in a directory of its own; every ``pass_*`` key of their
    records true, and K1 at both strides, K3's dx and dw, K2 and K4
    launched in the bf16 overfit."""
    records, failures = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = spawn([(["-m", "semstereo_tpu_torch.convergence", "--only", run, "--workdir",
                        f"{tmp}/{run}", "--out", f"{tmp}/{run}.json"], {})
                      for run in CONVERGENCE_RUNS], CONVERGENCE_TIMEOUT, check=False)
        wall = time.perf_counter() - t0
        for run, out in zip(CONVERGENCE_RUNS, outs):
            if not os.path.exists(f"{tmp}/{run}.json"):
                failures.append(f"convergence {run} wrote no record:\n{out[-3000:]}")
                continue
            with open(f"{tmp}/{run}.json") as f:
                records.update(json.load(f)["convergence"])
    for name, rec in records.items():
        failures += [f"{name}.{k}" for k, v in rec.items() if k.startswith("pass_") and not v]
        final = rec.get("final") or rec["stage2_final_eval"]
        log(f"convergence {name}: " + json.dumps(dict(
            {k: final[k] for k in ("EPE", "D1", "mIoU")}, wall_s=rec["wall_s"],
            **{k: rec[k] for k in ("stage1_final_eval", "partial_restore_tensors",
                                   "partial_restore_expected", "standalone_eval_epe")
               if k in rec})))
    launched = records.get("overfit_bf16", {}).get("launches", {})
    if not launched or min(launched.values()) == 0:
        failures.append(f"the bf16 overfit left a kernel unlaunched: {launched}")
    res = dict(records, wall_s=wall)
    log(f"convergence: {res['wall_s']:.1f} s for the three runs at once")
    if failures:
        raise AssertionError("convergence: " + "; ".join(failures))
    return res


def fp32_without_tf32() -> None:
    """fp32 convs and matmuls in fp32, not TF32 (cuDNN's default), so that
    the fp32 comparisons see summation order only."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def worker(argv: list[str]) -> int:
    """``--worker dp-step OUT``, ``--worker dp-cli OUT CLI-ARGS...``,
    ``--worker disp OUT CLI-ARGS...``, ``--worker space OUT CLI-ARGS...``,
    ``--worker space4 OUT``, ``--worker disp-space OUT CLI-ARGS...``,
    or ``--worker dds-step OUT``: one process of the data-, disp-, space- or
    disp x space-parallel phase."""
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 1
    fp32_without_tf32()
    kind, out = argv[0], argv[1]
    if kind == "dp-step":
        dp_step_worker(out)
    elif kind == "disp":
        disp_worker(out, argv[2:])
    elif kind == "space":
        space_worker(out, argv[2:])
    elif kind == "space4":
        space4_worker(out)
    elif kind == "disp-space":
        disp_space_worker(out, argv[2:])
    elif kind == "dds-step":
        dds_step_worker(out)
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
    run_bf16_curves(ops)
    t = phase("bf16 curves", t)
    run_convergence()
    t = phase("convergence", t)
    with tempfile.TemporaryDirectory() as tmp:
        run_trainer(ops, tmp, write_dataset(f"{tmp}/data"))
        t = phase("trainer", t)
        run_data_parallel(ops, tmp)
        t = phase("data parallel", t)
        run_disp_parallel(ops, tmp)
        t = phase("disp parallel", t)
        refs = split_references()
        space = run_space_parallel(ops, tmp, path, train, refs)
        t = phase("space parallel", t)
        run_disp_space_parallel(ops, tmp, train, refs, space)
        phase("disp x space parallel", t)

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
