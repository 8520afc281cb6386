"""The port's losses, metrics and label warp against ``semstereo_tpu.losses``,
``semstereo_tpu.metrics`` and ``semstereo_tpu.ops.warp.lrsc_label_warp``, on
the CPU in fp32, on inputs drawn with numpy.

Tolerance rtol = atol = 1e-5: the same fp32 arithmetic, summed in another
order over at most a few thousand terms.  Integer results (the warped
labels, the confusion matrix) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semstereo_tpu import losses as jlosses
from semstereo_tpu import metrics as jmetrics
from semstereo_tpu.ops.warp import lrsc_label_warp as jwarp
from semstereo_tpu_torch import losses, metrics
from semstereo_tpu_torch.ops import lrsc_label_warp

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, W, NC = 2, 12, 16, 6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), **tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-20, 20, (B, H, W)).astype(np.float32)
    gt[0, :2] = -1000.0  # the invalid sentinel
    est = (gt + rng.normal(0, 3, gt.shape)).astype(np.float32)
    logits = rng.standard_normal((B, H, W, NC)).astype(np.float32) * 2
    labels = rng.integers(0, NC, (B, H, W)).astype(np.float32)
    mask = ((gt < 16) & (gt >= -16)).astype(np.float32)
    return dict(gt=gt, est=est, logits=logits, labels=labels, mask=mask, rng=rng)


def test_smooth_l1_and_disparity_losses():
    d = _inputs(0)
    _close(losses.smooth_l1(_t(d["est"]), _t(d["gt"])), jlosses.smooth_l1(d["est"], d["gt"]))
    ests = [d["est"] + i for i in range(4)]
    gts = [d["gt"]] * 4
    masks = [d["mask"], np.zeros_like(d["mask"]), d["mask"], d["mask"]]  # one empty mask
    _close(losses.disp_loss_train([_t(e) for e in ests], [_t(g) for g in gts],
                                  [_t(m) for m in masks]),
           jlosses.disp_loss_train(ests, gts, masks))
    _close(losses.disp_loss_eval(_t(d["est"]), _t(d["gt"]), _t(d["mask"])),
           jlosses.disp_loss_eval(d["est"], d["gt"], d["mask"]))


@pytest.mark.parametrize("ignore", [None, 5, 255])
def test_cross_entropy(ignore):
    d = _inputs(1)
    labels = d["labels"].copy()
    if ignore == 255:
        labels[1, 3:6] = 255
    _close(losses.cross_entropy(_t(d["logits"]), _t(labels), ignore),
           jlosses.cross_entropy(d["logits"], labels, ignore))


@pytest.mark.parametrize("ignore", [None, 5, 255])
def test_dice_loss(ignore):
    """Also a class absent from an image whose predicted mass is 0 on it:
    dice 1 for that (image, class) pair."""
    d = _inputs(2)
    labels = d["labels"].copy()
    labels[0] = np.where(labels[0] == 2, 1, labels[0])
    logits = d["logits"].copy()
    logits[0, ..., 2] = -1e4
    if ignore == 255:
        labels[1, :4] = 255
    _close(losses.dice_loss(_t(logits), _t(labels), NC, ignore),
           jlosses.dice_loss(logits, labels, NC, ignore))


@pytest.mark.parametrize("stage1", [True, False])
def test_label_loss(stage1):
    d = _inputs(3)
    _close(losses.label_loss(_t(d["logits"]), _t(d["labels"]), NC, stage1, 5),
           jlosses.label_loss(d["logits"], d["labels"], NC, stage1, 5))


def test_lrsc_label_warp_and_loss():
    d = _inputs(4)
    disp = d["rng"].uniform(-30, 30, (B, H, W)).astype(np.float32)  # some leave the image
    got = lrsc_label_warp(_t(d["labels"]), _t(disp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwarp(d["labels"], disp)))
    disp_t = _t(disp).requires_grad_()
    loss = losses.lrsc_loss(_t(d["logits"]), disp_t, _t(d["labels"]))
    _close(loss, jlosses.lrsc_loss(d["logits"], disp, d["labels"]))
    assert not loss.requires_grad  # the disparity enters only through the index


def test_loss_gradients_match_jax():
    """Gradients of the seg + LRSC terms w.r.t. the logits and of the
    smooth-L1 pyramid w.r.t. the estimate."""
    import jax

    d = _inputs(5)
    logits = _t(d["logits"]).requires_grad_()
    est = _t(d["est"]).requires_grad_()
    total = (losses.label_loss(logits, _t(d["labels"]), NC, False, 5)
             + losses.lrsc_loss(logits, est, _t(d["labels"]))
             + losses.disp_loss_train([est], [_t(d["gt"])], [_t(d["mask"])]))
    g_logits, g_est = torch.autograd.grad(total, (logits, est))

    def f(lg, e):
        return (jlosses.label_loss(lg, d["labels"], NC, False, 5)
                + jlosses.lrsc_loss(lg, e, d["labels"])
                + jlosses.disp_loss_train([e], [d["gt"]], [d["mask"]]))

    want = jax.grad(f, (0, 1))(jnp.asarray(d["logits"]), jnp.asarray(d["est"]))
    _close(g_logits, want[0])
    _close(g_est, want[1])


def test_focal_loss():
    d = _inputs(6)
    for ignore in (-1, 5):
        _close(losses.focal_loss(_t(d["logits"]), _t(d["labels"]), 2.0, ignore),
               jlosses.focal_loss(d["logits"], d["labels"], 2.0, ignore))


def test_disparity_metrics():
    """Image 0 has a mask covering < 10 % of its gt > 0 pixels and is
    skipped."""
    d = _inputs(7)
    gt = np.abs(d["gt"]) + 0.5
    mask = (gt < 16).astype(bool)
    mask[0] = False
    mask[0, 0, :3] = True
    args_t = (_t(d["est"]), _t(gt), _t(mask))
    args_j = (d["est"], gt, mask)
    _close(metrics.epe_metric(*args_t), jmetrics.epe_metric(*args_j))
    _close(metrics.d1_metric(*args_t), jmetrics.d1_metric(*args_j))
    for thres in (1.0, 2.0, 3.0):
        _close(metrics.thres_metric(*args_t, thres), jmetrics.thres_metric(*args_j, thres))


def test_confusion_matrix_and_meter():
    d = _inputs(8)
    labels = d["labels"].copy()
    labels[0, 0] = 255  # outside the classes: counts nowhere
    got = metrics.confusion_matrix(_t(d["logits"]), _t(labels), NC - 1)
    want = np.asarray(jmetrics.confusion_matrix(d["logits"], labels, NC - 1))
    np.testing.assert_array_equal(got.numpy(), want)
    meter, jmeter = metrics.SegmentationMeter(NC - 1), jmetrics.SegmentationMeter(NC - 1)
    for _ in range(2):
        meter.add_batch(_t(d["logits"]), _t(labels))
        jmeter.add_batch(d["logits"], labels)
    for name in ("pixel_accuracy", "mean_pixel_accuracy", "mean_iou", "fw_iou"):
        np.testing.assert_allclose(getattr(meter, name)(), getattr(jmeter, name)(), rtol=1e-12)
    np.testing.assert_array_equal(meter.class_pixel_accuracy(), jmeter.class_pixel_accuracy())
    meter.reset()
    assert meter.cm.sum() == 0
