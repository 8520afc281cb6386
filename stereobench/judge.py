"""What decides ``correct``: the numbers that compare the timed path's
outputs with the plain reference's, and each one's limit.

The reference follows the program's hard choices of planes
(``choices.py``); ``topk_violation`` and ``refine_violation`` say how far
those choices are from its own (``reference/model.py``).

Eval (each pair of a sample of the window's requests; the worst pair
counts):
  label_rel   ||label_l - reference|| / ||reference|| over the whole map;
  disp_med    the median |disparity - reference| in px.
Train (the first three steps, which set-up drives through the window's
own call):
  loss_rel, loss_rel_first  the largest relative gap of a step's total
              loss, and the first step's; ``<term>_rel`` each of the first
              step's loss terms;
  grad_leaf   the largest gap between the norms of a leaf's first gradient
              (the program's worked out from Adam's first moment after one
              step), over the larger of the reference leaf's norm and the
              median leaf's; grad_leaf_median the median leaf's gap;
  grad_module_median  the median over the model's top-level modules of
              the same gap for the norm of each module's kept leaves
              together (a module sums many leaves' rounding, and a fault in
              one kernel's backward moves the modules it reaches);
  grad_rank   the largest over the leaves' tensor ranks (1: normalisation
              scales and biases, 2: linear, 4: 2-D and 5: 3-D convolution
              kernels) of the gap of the norm of that rank's kept leaves
              together, over that norm: K3's dw reaches the 3-D kernels,
              K4 the 2-D ones through the features;
  change_leaf, change_leaf_median  the same as for the gradient, for each
              leaf's change over the three steps; change_leaf_kept the
              worst leaf's, over the elements whose reference gradient is
              at least a hundredth of the median leaf's root-mean-square
              element (``kept_elements``).
  Leaves whose reference gradient is under a thousandth of the median
  leaf's (a bias before a BatchNorm, nought but for rounding) are left out.
A cell's ``limits/<cell>.json`` names the numbers it compares; the other
readings are printed beside them and decide nothing.
"""

from __future__ import annotations

import math
import statistics

import torch

ZERO_GRAD = 1e-3
ELEMENT = 1e-2


def pair_numbers(disp, label, ref_disp, ref_label) -> dict:
    """One pair's readings: disparity [H, W], label logits [H, W, C]."""
    dl = (label.float() - ref_label.float()).flatten()
    return {"label_rel": (dl.norm() / ref_label.float().norm()).item(),
            "disp_med": (disp.float() - ref_disp.float()).abs().median().item()}


def worst(readings: list[dict]) -> dict:
    """The largest of each reading over the pairs."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def _gaps(got: dict, want: dict, keep) -> dict:
    """|got - want| / max(want, the median of want) of each kept leaf."""
    med = statistics.median(want[k] for k in keep)
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keep}


def train_numbers(got: dict, want: dict) -> dict:
    """got, want: {'loss': [per step], 'terms': {the first step's loss
    terms}, 'grad': {leaf: norm}, 'change': {leaf: tensor}} of the
    program and of the reference; want['rank']: {leaf: its tensor rank},
    want['kept']: {leaf: ``kept_elements``' mask}."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    med = statistics.median(want["grad"].values())
    keep = [k for k, v in want["grad"].items() if v >= ZERO_GRAD * med]
    grad = _gaps(got["grad"], want["grad"], keep)
    norms = lambda d: {k: d["change"][k].norm().item() for k in keep}  # noqa: E731
    change = _gaps(norms(got), norms(want), keep)
    kept = lambda d: {k: d["change"][k][want["kept"][k]].norm().item() for k in keep}  # noqa: E731
    change_kept = _gaps(kept(got), kept(want), keep)
    got_m, want_m = (_groups(d["grad"], keep, lambda k: k.split(".")[0]) for d in (got, want))
    modules = _gaps(got_m, want_m, list(want_m))
    got_r, want_r = (_groups(d["grad"], keep, want["rank"].get) for d in (got, want))
    loss_first = abs(got["loss"][0] - want["loss"][0]) / abs(want["loss"][0])
    terms = {f"{k}_rel": abs(got["terms"][k] - v) / abs(v) for k, v in want["terms"].items()}
    worst = lambda gaps: sorted(gaps.items(), key=lambda kv: -kv[1])[:5]  # noqa: E731
    return {"loss_rel": loss_rel, "loss_rel_first": loss_first, **terms,
            "grad_leaf": max(grad.values()), "change_leaf": max(change.values()),
            "grad_leaf_median": statistics.median(grad.values()),
            "change_leaf_median": statistics.median(change.values()),
            "change_leaf_kept": max(change_kept.values()),
            "grad_module_median": statistics.median(modules.values()),
            "grad_rank": max(abs(got_r[r] - v) / v for r, v in want_r.items()),
            "leaves_compared": float(len(keep)), "leaves": float(len(want["grad"])),
            **want.get("margins", {}), "grad_worst": worst(grad), "change_worst": worst(change_kept)}


def kept_elements(grads: dict) -> dict:
    """Of each leaf, the elements whose reference gradient is at least
    ``ELEMENT`` of the median kept leaf's root-mean-square element (a mask
    on the host); the others (the key part of an attention's bias, the
    last MLP bias of a backbone block) move under Adam by rounding alone."""
    norms = {k: g.norm().item() for k, g in grads.items()}
    med = statistics.median(norms.values())
    rms = statistics.median(v / math.sqrt(grads[k].numel()) for k, v in norms.items()
                            if v >= ZERO_GRAD * med)
    return {k: (g.abs() >= ELEMENT * rms).cpu() for k, g in grads.items()}


def _groups(norms: dict, keep: list, group) -> dict:
    """The norm of each group's kept leaves together."""
    sq = {}
    for k in keep:
        sq[group(k)] = sq.get(group(k), 0.0) + norms[k] ** 2
    return {g: math.sqrt(v) for g, v in sq.items()}


def decide(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {value, limit}}) over the numbers with a limit; a
    number that is missing or not finite fails."""
    checks = {}
    ok = True
    for name, spec in limits["numbers"].items():
        value = readings.get(name, math.nan)
        checks[name] = {"value": value, "limit": spec["limit"]}
        ok = ok and math.isfinite(value) and value <= spec["limit"]
    return ok, checks


def fp32_exact():
    """fp32 matrix products and convolutions without TF32, as the reference
    states them; returns a function that restores the previous settings."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    return restore
