"""The US3D train step in plain PyTorch: the losses of the recipe and Adam.

Losses (masked means, sum(l * m) / max(sum(m), 1)):
  disparity: smooth-L1 (beta 1) of each output against the ground truth at
    its scale, weighted (1.0, 0.6, 0.5, 0.3) in stage 2 and (1.0, 0.6) in
    stage 1, over the valid pixels -maxdisp <= d < maxdisp;
  segmentation: (cross-entropy ignoring class 5 + soft dice over classes
    0-4, per image and class, eps 1e-6) x 2.4 in stage 2, x 1.6 in stage 1;
  LRSC: cross-entropy of the right head against the left ground-truth
    labels warped to the right view by the first disparity output
    (detached), column clip(x - d, 0, W - 1) truncated.
Adam: betas (0.9, 0.999), eps 1e-8 added to the bias-corrected root of the
second moment, lr 1e-3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DISP_WEIGHTS = (1.0, 0.6, 0.5, 0.3)


def masked_mean(x, mask):
    return torch.sum(x * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def smooth_l1(pred, target):
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def cross_entropy(logits, labels, ignore_index=None):
    labels = labels.long()
    valid = torch.ones_like(labels, dtype=torch.bool) if ignore_index is None \
        else labels != ignore_index
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return masked_mean(nll, valid.float())


def dice_loss(logits, labels, num_classes: int, ignore_index: int):
    prob = torch.softmax(logits, dim=-1)
    ids = labels.long()
    onehot = F.one_hot(ids.clamp(0, num_classes - 1), num_classes).float()
    onehot = onehot * ((ids >= 0) & (ids < num_classes))[..., None]
    keep = [i for i in range(num_classes) if i != ignore_index]
    prob, onehot = prob[..., keep], onehot[..., keep]
    inter = 2.0 * torch.sum(prob * onehot, dim=(1, 2))
    sets = torch.sum(prob, dim=(1, 2)) + torch.sum(onehot, dim=(1, 2))
    sets = torch.where(sets == 0, inter, sets)
    return 1.0 - torch.mean((inter + 1e-6) / (sets + 1e-6))


def losses(out: dict, batch: dict, maxdisp: int, num_classes: int, stage1: bool,
           ignore_index: int = 5) -> dict:
    """The loss terms and their sum ('loss') of one forward's outputs."""
    gt, gt4 = batch["disparity"], batch["disparity_4"]
    valid = lambda d: ((d < maxdisp) & (d >= -maxdisp)).float()  # noqa: E731
    ests = out["disp"]
    gts = [gt, gt4, gt, gt4][:len(ests)]
    disp = sum(w * masked_mean(smooth_l1(e, g), valid(g))
               for e, g, w in zip(ests, gts, DISP_WEIGHTS))
    seg = (cross_entropy(out["label_l"], batch["label"], ignore_index)
           + dice_loss(out["label_l"], batch["label"], num_classes, ignore_index))
    seg = seg * (1.6 if stage1 else 2.4)
    w = gt.shape[2]
    xs = torch.arange(w, dtype=torch.float32, device=gt.device) - ests[0].detach()
    warped = torch.gather(batch["label"], 2, xs.clamp(0.0, w - 1.0).long())
    lrsc = cross_entropy(out["label_r"], warped)
    return {"disp_loss": disp, "label_loss": seg, "lrsc_loss": lrsc,
            "loss": disp + seg + lrsc}


class Adam:
    """Adam on a list of parameters, state kept per parameter."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
