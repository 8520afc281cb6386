"""Training losses: multi-scale disparity, segmentation (CE + dice) and the
LRSC left-right semantic-consistency loss (counterpart of
``semstereo_tpu/losses.py``).

Every loss is a masked mean, sum(loss * mask) / max(sum(mask), 1), so an
empty mask gives 0.  Label logits are channels-last [B, H, W, C]; targets
are [B, H, W] class ids (any dtype).  Under data parallelism the
denominators (mask sums, the dice term's count) are summed over the
processes, so each process's loss is its share of the global-batch loss
(``parallel.py``); that holds under spatial parallelism too, where the
processes of a space group hold distinct rows of the same images.  The
dice loss is not a masked mean: ``dice_loss`` says how it is split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semstereo_tpu_torch.ops.warp import lrsc_label_warp
from semstereo_tpu_torch.parallel import global_sum, process_count, space_sum

# Pyramid weights for (full-res refined, 1/4 refined, full-res att, 1/4 att).
DISP_WEIGHTS_FULL = (1.0, 0.6, 0.5, 0.3)


def _one_hot(labels, num_classes: int, dtype):
    """One-hot of class ids; an id outside [0, num_classes) gives zeros."""
    ids = labels.long()
    onehot = F.one_hot(torch.clamp(ids, 0, num_classes - 1), num_classes).to(dtype)
    return onehot * ((ids >= 0) & (ids < num_classes))[..., None].to(dtype)


def _masked_mean(x, mask):
    return torch.sum(x * mask) / torch.clamp_min(global_sum(torch.sum(mask)), 1.0)


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


def dice_loss(logits, labels, num_classes: int, ignore_index: int | None = 5, rows=None):
    """Multiclass soft dice over the spatial axes per (image, class),
    averaged, eps 1e-6; an (image, class) pair whose union is 0 scores 1.
    An ``ignore_index`` inside [0, num_classes) drops that class; one
    outside it (255, say) masks the ignored pixels out of the union.

    On row slabs (``rows``, a mesh whose space axis splits the images) the
    sums over H and W run over the whole image: each process sums its rows,
    and ``inter`` and ``sets`` are all-reduced over the space group
    (``space_sum``) before the ratio, so every process of the group holds
    the same dice values D.  The share: with N = the world's count of
    (image, class) pairs, each process's loss is (n - sum D) / N for its n
    pairs; a space group's ``space`` processes hold the same n pairs, so the
    shares summed over the world give ``space`` times each image's term
    over N, which counts each pair ``space`` times: the global mean, each
    process adding 1/space of its group's term.  The gradient: process p's
    share depends on its rows only through the sums, S = sum_q s_q.  The
    all-reduce's adjoint sums the cotangent of S over the group,
    sum_q dL_q/dS = space * (-(1/N) dD/dS), which is dL/dS of the summed
    loss, and dS/ds_p = 1 carries it into p's rows; the gradient
    all-reduce then sums the parameters' parts once."""
    prob = torch.softmax(logits, dim=-1)
    onehot = _one_hot(labels, num_classes, prob.dtype)
    if ignore_index is not None and 0 <= ignore_index < num_classes:
        keep = [i for i in range(num_classes) if i != ignore_index]
        prob, onehot = prob[..., keep], onehot[..., keep]
    elif ignore_index is not None:
        prob = prob * (labels != ignore_index)[..., None].to(prob.dtype)
    inter = 2.0 * torch.sum(prob * onehot, dim=(1, 2))  # [B, C']
    sets = torch.sum(prob, dim=(1, 2)) + torch.sum(onehot, dim=(1, 2))
    if rows is not None:
        inter, sets = space_sum(torch.stack([inter, sets]), rows).unbind()
    sets = torch.where(sets == 0, inter, sets)
    dice = (inter + 1e-6) / (sets + 1e-6)
    if process_count() == 1:
        return 1.0 - torch.mean(dice)
    n = global_sum(dice.numel())  # the mean over the global batch, as shares
    return dice.numel() / n - torch.sum(dice) / n


def label_loss(logits, labels, num_classes: int, attention_weights_only: bool,
               ignore_index: int = 5, rows=None):
    """(CE with ignore + dice) x 1.6 in stage 1, x 2.4 in stage 2; on row
    slabs with ``rows`` (``dice_loss``)."""
    loss = cross_entropy(logits, labels, ignore_index) + dice_loss(
        logits, labels, num_classes, ignore_index, rows)
    return loss * (1.6 if attention_weights_only else 2.4)


def lrsc_loss(label_logits_r, disp_est, label_gt_l):
    """Left-right semantic consistency: the left label map warped to the
    right view by the predicted disparity (detached: the gather index
    carries no gradient) supervises the right segmentation head."""
    warped = lrsc_label_warp(label_gt_l, disp_est.detach())
    return cross_entropy(label_logits_r, warped, ignore_index=None)


def focal_loss(logits, labels, gamma: float = 2.0, ignore_index: int = -1):
    """Multiclass focal loss, the mean over the pixels (their count summed
    over the processes, so each process's value is its share, under data
    and spatial parallelism alike); the ``ignore_index`` class (if >= 0)
    has no target."""
    num_classes = logits.shape[-1]
    onehot = _one_hot(labels, num_classes, logits.dtype)
    if ignore_index >= 0:
        onehot[..., ignore_index] = 0.0
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    focal = -onehot * ((1 - p) ** gamma) * logp
    per_pixel = torch.sum(focal, dim=-1)
    if process_count() == 1:
        return torch.mean(per_pixel)
    return torch.sum(per_pixel) / global_sum(per_pixel.numel())
