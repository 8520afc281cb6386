"""Seeded weights of a configuration, made on the device in a few calls.

The keys and shapes are the plain reference's (``reference.build``),
which the port shares; the same state dict loads into both.  Values:
conv and deconv kernels normal(0, sqrt(2 / fan_out)) with fan_out =
kernel volume x output channels, Linear kernels normal(0, sqrt(1 / fan_in)),
biases 0, GroupNorm scale 1; BatchNorm with non-trivial statistics and
affine (scale 1 + 0.1 n, shift 0.05 n, running mean 0.1 n, running
variance 0.5 + u); the classifiers' output kernels x 8, so the disparity
posteriors are peaked; gamma 0, beta 2.  One normal and one uniform draw
from a ``torch.Generator`` on the device cover them all, in key order.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stereobench import reference
from stereobench.reference.model import BatchNorm

CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
SHARPENED = ("classif_att_.2.weight", "classif.2.weight")
CONSTANT = {"gamma": 0.0, "beta": 2.0}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 16 + stream) % 2**63)


def _plan(model: nn.Module) -> dict:
    """key -> (draw, mean, scale): draw is 'normal', 'uniform' or None."""
    plan = {}
    for name, m in model.named_modules():
        p = name + "." if name else ""
        if isinstance(m, CONVS):
            fan_out = m.weight[0, 0].numel() * m.out_channels
            plan[p + "weight"] = ("normal", 0.0, (2.0 / fan_out) ** 0.5)
        elif isinstance(m, nn.Linear):
            plan[p + "weight"] = ("normal", 0.0, (1.0 / m.in_features) ** 0.5)
        elif isinstance(m, BatchNorm):
            plan[p + "weight"] = ("normal", 1.0, 0.1)
            plan[p + "bias"] = ("normal", 0.0, 0.05)
            plan[p + "running_mean"] = ("normal", 0.0, 0.1)
            plan[p + "running_var"] = ("uniform", 0.5, 1.0)
    for key in SHARPENED:
        if key in plan:
            draw, mean, scale = plan[key]
            plan[key] = (draw, mean, 8.0 * scale)
    return plan


def make_state_dict(model_cfg: dict, seed: int, device) -> dict:
    """fp32 state dict of the configuration's network, from ``seed``."""
    with torch.device("meta"):
        model = reference.build(model_cfg)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    plan = _plan(model)
    count = {"normal": 0, "uniform": 0}
    for key, shape in shapes.items():
        draw = plan.get(key, (None,))[0]
        if draw:
            count[draw] += shape.numel()
    gen = generator(seed, 0, device)
    draws = {"normal": torch.randn(count["normal"], generator=gen, device=device),
             "uniform": torch.rand(count["uniform"], generator=gen, device=device)}
    used = {"normal": 0, "uniform": 0}
    out = {}
    for key, shape in shapes.items():
        draw, mean, scale = plan.get(key, (None, 0.0, 0.0))
        if draw is None:
            fill = CONSTANT.get(key, 1.0 if key.endswith("weight") else 0.0)
            out[key] = torch.full(shape, fill, device=device)
            continue
        n = shape.numel()
        out[key] = draws[draw][used[draw]:used[draw] + n].view(shape) * scale + mean
        used[draw] += n
    return out
