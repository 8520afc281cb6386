"""work.py's counts against hand counts of the kernel table's shapes
(PERF.md: bf16, 1024x1024, maxdisp 64; the eval request at batch 1, the
train step at batch 2)."""

import torch

from stereobench import work

BF16 = torch.bfloat16
# (x shape at batch 1, F, stride) of the 13 volume convs of a stage-2 request
K1 = [((1, 16, 128, 128, 32), 64, 2), ((1, 8, 64, 64, 64), 64, 1), ((1, 8, 64, 64, 64), 128, 2),
      ((1, 4, 32, 32, 128), 128, 1), ((1, 16, 128, 128, 32), 32, 1),
      ((1, 16, 128, 128, 32), 1, 1), ((1, 24, 256, 256, 64), 32, 1),
      ((1, 24, 256, 256, 32), 64, 2), ((1, 12, 128, 128, 64), 64, 1),
      ((1, 12, 128, 128, 64), 128, 2), ((1, 6, 64, 64, 128), 128, 1),
      ((1, 24, 256, 256, 32), 32, 1), ((1, 24, 256, 256, 32), 1, 1)]


def _ms(flops, nbytes):
    return 1e3 * work.bound_s(flops, nbytes, BF16)


def test_k1_stride1_bound_per_request():
    total = sum(_ms(*work.conv3d_fwd(x, f, s, BF16)) for x, f, s in K1 if s == 1)
    assert abs(total - 0.392) < 0.0005


def test_k1_stride2_bound_per_request():
    total = sum(_ms(*work.conv3d_fwd(x, f, s, BF16)) for x, f, s in K1 if s == 2)
    assert abs(total - 0.057) < 0.0005


def test_k1_hand_count():
    # concat_stem: 24*256*256 outputs, 27 taps x 64 in x 32 out, two operations each
    flops, nbytes = work.conv3d_fwd((1, 24, 256, 256, 64), 32, 1, BF16)
    assert flops == 2 * 24 * 256 * 256 * 27 * 64 * 32
    assert nbytes == (24 * 256 * 256 * 64 + 27 * 64 * 32 + 24 * 256 * 256 * 32) * 2 + 8 * 32


def test_k3_bound_per_train_step():
    total = sum(_ms(*work.conv3d_bwd((2, *x[1:]), f, s, BF16)) for x, f, s in K1)
    assert abs(total - 1.773) < 0.001


def test_k2_and_k4_bounds():
    assert abs(_ms(*work.gwc_fwd((1, 128, 128, 256), 16, BF16)) - 0.010) < 0.0005
    assert abs(_ms(*work.gwc_bwd((2, 128, 128, 256), 16, BF16)) - 0.030) < 0.0005


def test_model_flop_per_pair_counts_convs_and_products():
    cfg = dict(name="SemStereo", maxdisp=16, num_classes=6, att_weights_only=False, topk=4,
               refine_topk=2, att_window1=[1, 2, 2], att_window2=[1, 2, 2])
    fwd = work.model_flop_per_pair(cfg, 2, 64, 64, train=False)
    train = work.model_flop_per_pair(cfg, 2, 64, 64, train=True)
    assert fwd > 1e8 and 2.5 * fwd < train < 3.5 * fwd
    stage1 = work.model_flop_per_pair(dict(cfg, att_weights_only=True), 2, 64, 64, train=False)
    assert stage1 < fwd
