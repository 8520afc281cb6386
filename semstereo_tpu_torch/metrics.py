"""Evaluation metrics: disparity (EPE / D1 / Thres-k) and segmentation
(confusion matrix; PA / CPA / MPA / IoU / mIoU / FWIoU), counterpart of
``semstereo_tpu/metrics.py``.

The disparity metrics are per-image masked means averaged over the valid
images of the batch; an image is valid when its mask covers at least 10 %
of its pixels with gt > 0.  The confusion matrix is a one-hot product on
the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _per_image(metric_elem, mask):
    """Masked per-image mean of an elementwise metric: [B,H,W] -> [B]."""
    m = mask.float()
    return torch.sum(metric_elem * m, dim=(1, 2)) / torch.clamp_min(torch.sum(m, dim=(1, 2)), 1.0)


def _image_validity(d_gt, mask):
    """1.0 for images whose valid-mask coverage is >= 10 % of their gt > 0 pixels."""
    m = torch.mean(mask.float(), dim=(1, 2))
    g = torch.mean((d_gt > 0).float(), dim=(1, 2))
    return (m / torch.clamp_min(g, 1e-12) >= 0.1).float()


def _batch_mean(per_image_vals, validity):
    return torch.sum(per_image_vals * validity) / torch.clamp_min(torch.sum(validity), 1.0)


def epe_metric(d_est, d_gt, mask):
    """Masked mean absolute error."""
    err = torch.abs(d_est - d_gt)
    return _batch_mean(_per_image(err, mask), _image_validity(d_gt, mask))


def d1_metric(d_est, d_gt, mask):
    """Share of pixels with error > 3 px and > 5 % of |gt|."""
    err = torch.abs(d_est - d_gt)
    bad = (err > 3.0) & (err / torch.clamp_min(torch.abs(d_gt), 1e-12) > 0.05)
    return _batch_mean(_per_image(bad.float(), mask), _image_validity(d_gt, mask))


def thres_metric(d_est, d_gt, mask, thres: float):
    """Share of pixels with error > ``thres`` px."""
    bad = (torch.abs(d_est - d_gt) > thres).float()
    return _batch_mean(_per_image(bad, mask), _image_validity(d_gt, mask))


def confusion_matrix(logits, labels, num_classes: int):
    """[C, C] confusion matrix, rows ground truth, columns the argmax of
    ``logits`` [B,H,W,C']; pixels whose label or prediction falls outside
    [0, num_classes) count nowhere."""
    pred = torch.argmax(logits, dim=-1)
    gt = labels.long()
    valid = (gt >= 0) & (gt < num_classes) & (pred < num_classes)
    oh_gt = F.one_hot(torch.where(valid, gt, 0), num_classes).float()
    oh_pr = F.one_hot(torch.where(valid, pred, 0), num_classes).float()
    w = valid.float()[..., None]
    return torch.einsum("bhwi,bhwj->ij", oh_gt * w, oh_pr)


class SegmentationMeter:
    """Host-side accumulator of confusion matrices."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), np.float64)

    def add_batch(self, logits, labels):
        self.add_confusion(confusion_matrix(logits, labels, self.num_classes))

    def add_confusion(self, cm):
        self.cm += cm.detach().cpu().double().numpy() if torch.is_tensor(cm) else np.asarray(cm)

    def pixel_accuracy(self):
        return np.diag(self.cm).sum() / max(self.cm.sum(), 1e-12)

    def class_pixel_accuracy(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(self.cm) / self.cm.sum(axis=1)

    def mean_pixel_accuracy(self):
        return np.nanmean(self.class_pixel_accuracy())

    def iou(self):
        inter = np.diag(self.cm)
        union = self.cm.sum(axis=1) + self.cm.sum(axis=0) - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            return inter / union

    def mean_iou(self):
        return np.nanmean(self.iou())

    def fw_iou(self):
        freq = self.cm.sum(axis=1) / max(self.cm.sum(), 1e-12)
        iu = self.iou()
        sel = freq > 0
        return float((freq[sel] * iu[sel]).sum())

    def reset(self):
        self.cm[:] = 0
