"""Disparity regression, variance and top-k plane selection.

Counterpart of ``semstereo_tpu/ops/regression.py``.  Volumes are
[B, D, H, W]; plane d maps to disparity ``d - D/2`` (symmetric, US3D) or
``d`` (positive, WHU).
"""

from __future__ import annotations

import torch


def disparity_values(ndisp: int, symmetric: bool, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Per-plane disparity values: arange(-D/2, D/2) or arange(0, D)."""
    if symmetric:
        if ndisp % 2:
            raise ValueError(f"symmetric range needs an even plane count, got {ndisp}")
        return torch.arange(-(ndisp // 2), ndisp // 2, dtype=dtype, device=device)
    return torch.arange(ndisp, dtype=dtype, device=device)


def disparity_regression(prob: torch.Tensor, symmetric: bool) -> torch.Tensor:
    """Soft-argmin: sum_d p[d] * disp(d).  prob [B, D, H, W] -> [B, H, W]."""
    vals = disparity_values(prob.shape[1], symmetric, prob.dtype, prob.device)
    return torch.sum(prob * vals[None, :, None, None], dim=1)


def disparity_variance(prob: torch.Tensor, disparity: torch.Tensor,
                       symmetric: bool) -> torch.Tensor:
    """sum_d p[d] * (disp(d) - d_hat)^2.  prob [B, D, H, W], disparity
    [B, H, W] -> [B, H, W]."""
    vals = disparity_values(prob.shape[1], symmetric, prob.dtype, prob.device)
    sq = torch.square(vals[None, :, None, None] - disparity[:, None])
    return torch.sum(prob * sq, dim=1)


def topk_planes(weights: torch.Tensor, k: int, symmetric: bool):
    """The k highest-weight disparity planes per pixel.

    weights [B, D, H, W] raw (pre-softmax).  Top-k is taken on the raw
    weights (softmax is monotonic), the indices are re-sorted ascending and
    the kept softmax probabilities are recovered from the logsumexp.

    Returns (topk_prob, topk_raw, samples), each [B, k, H, W]; samples are
    the plane disparities ``ind - D/2`` (symmetric) or ``ind``.
    """
    d = weights.shape[1]
    if k > d:
        raise ValueError(f"top-{k} of {d} planes")
    raw_l = weights.movedim(1, -1)  # [B, H, W, D]
    ind = torch.topk(raw_l, k, dim=-1).indices
    ind = torch.sort(ind, dim=-1).values
    topk_raw = torch.gather(raw_l, -1, ind)
    lse = torch.logsumexp(raw_l, dim=-1, keepdim=True)
    topk_prob = torch.exp(topk_raw - lse)
    offset = d // 2 if symmetric else 0
    samples = ind.to(weights.dtype) - offset
    return (topk_prob.movedim(-1, 1), topk_raw.movedim(-1, 1),
            samples.movedim(-1, 1))


def regression_topk(cost: torch.Tensor, disparity_samples: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Soft-argmin over the k best sampled planes.
    cost, disparity_samples [B, D, H, W] -> [B, H, W]."""
    cost_l = cost.movedim(1, -1)
    samp_l = disparity_samples.movedim(1, -1)
    topv, ind = torch.topk(cost_l, k, dim=-1)
    prob = torch.softmax(topv, dim=-1)
    samp = torch.gather(samp_l, -1, ind)
    return torch.sum(prob * samp, dim=-1)
