"""Training losses: multi-scale disparity, segmentation (CE + dice) and the
LRSC left-right semantic-consistency loss (counterpart of
``semstereo_tpu/losses.py``).

Every loss is a masked mean, sum(loss * mask) / max(sum(mask), 1), so an
empty mask gives 0.  Label logits are channels-last [B, H, W, C]; targets
are [B, H, W] class ids (any dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semstereo_tpu_torch.ops.warp import lrsc_label_warp

# Pyramid weights for (full-res refined, 1/4 refined, full-res att, 1/4 att).
DISP_WEIGHTS_FULL = (1.0, 0.6, 0.5, 0.3)


def _one_hot(labels, num_classes: int, dtype):
    """One-hot of class ids; an id outside [0, num_classes) gives zeros."""
    ids = labels.long()
    onehot = F.one_hot(torch.clamp(ids, 0, num_classes - 1), num_classes).to(dtype)
    return onehot * ((ids >= 0) & (ids < num_classes))[..., None].to(dtype)


def _masked_mean(x, mask):
    return torch.sum(x * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def smooth_l1(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def disp_loss_train(disp_ests, disp_gts, masks, weights=None):
    """Weighted smooth-L1 pyramid."""
    if weights is None:
        weights = DISP_WEIGHTS_FULL[: len(disp_ests)]
    total = 0.0
    for est, gt, w, m in zip(disp_ests, disp_gts, weights, masks):
        total = total + w * _masked_mean(smooth_l1(est, gt), m)
    return total


def disp_loss_eval(disp_est, disp_gt, mask):
    """Masked L1 on the single eval output."""
    return _masked_mean(torch.abs(disp_est - disp_gt), mask)


def cross_entropy(logits, labels, ignore_index: int | None = None):
    """Mean CE over the pixels whose label is not ``ignore_index``;
    logits [B,H,W,C], labels [B,H,W]."""
    labels = labels.long()
    valid = torch.ones_like(labels, dtype=torch.bool) if ignore_index is None \
        else labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return _masked_mean(nll, valid.to(nll.dtype))


def dice_loss(logits, labels, num_classes: int, ignore_index: int | None = 5):
    """Multiclass soft dice over the spatial axes per (image, class),
    averaged, eps 1e-6; an (image, class) pair whose union is 0 scores 1.
    An ``ignore_index`` inside [0, num_classes) drops that class; one
    outside it (255, say) masks the ignored pixels out of the union."""
    prob = torch.softmax(logits, dim=-1)
    onehot = _one_hot(labels, num_classes, prob.dtype)
    if ignore_index is not None and 0 <= ignore_index < num_classes:
        keep = [i for i in range(num_classes) if i != ignore_index]
        prob, onehot = prob[..., keep], onehot[..., keep]
    elif ignore_index is not None:
        prob = prob * (labels != ignore_index)[..., None].to(prob.dtype)
    inter = 2.0 * torch.sum(prob * onehot, dim=(1, 2))  # [B, C']
    sets = torch.sum(prob, dim=(1, 2)) + torch.sum(onehot, dim=(1, 2))
    sets = torch.where(sets == 0, inter, sets)
    dice = (inter + 1e-6) / (sets + 1e-6)
    return 1.0 - torch.mean(dice)


def label_loss(logits, labels, num_classes: int, attention_weights_only: bool,
               ignore_index: int = 5):
    """(CE with ignore + dice) x 1.6 in stage 1, x 2.4 in stage 2."""
    loss = cross_entropy(logits, labels, ignore_index) + dice_loss(
        logits, labels, num_classes, ignore_index)
    return loss * (1.6 if attention_weights_only else 2.4)


def lrsc_loss(label_logits_r, disp_est, label_gt_l):
    """Left-right semantic consistency: the left label map warped to the
    right view by the predicted disparity (detached: the gather index
    carries no gradient) supervises the right segmentation head."""
    warped = lrsc_label_warp(label_gt_l, disp_est.detach())
    return cross_entropy(label_logits_r, warped, ignore_index=None)


def focal_loss(logits, labels, gamma: float = 2.0, ignore_index: int = -1):
    """Multiclass focal loss; the ``ignore_index`` class (if >= 0) has no
    target."""
    num_classes = logits.shape[-1]
    onehot = _one_hot(labels, num_classes, logits.dtype)
    if ignore_index >= 0:
        onehot[..., ignore_index] = 0.0
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    focal = -onehot * ((1 - p) ** gamma) * logp
    return torch.mean(torch.sum(focal, dim=-1))
