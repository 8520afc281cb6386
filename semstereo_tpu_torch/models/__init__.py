"""Model registry (counterpart of ``semstereo_tpu.models``).

``SemStereo`` uses symmetric disparities [-maxdisp, maxdisp) (US3D);
``SemStereo_WHU`` the positive range [0, maxdisp).
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn

from semstereo_tpu_torch.config import ModelConfig
from semstereo_tpu_torch.models.semstereo import FeatUp, SemStereo

SemStereoWHU = functools.partial(SemStereo, symmetric=False)

__models__ = {
    "SemStereo": SemStereo,
    "SemStereo_WHU": SemStereoWHU,
}


def build_model(cfg: ModelConfig = ModelConfig(), device="cuda", dtype=torch.float32,
                seed: int = 0, fuse_views=None) -> SemStereo:
    """The eval model of ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU), weights drawn from a ``torch.Generator`` seeded with
    ``seed``.  ``fuse_views`` (eval only; None is the two-pass front end)
    is a model attribute, as in the JAX package, not a config field."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' to run on the CPU")
    model = __models__[cfg.name](
        maxdisp=cfg.maxdisp, num_classes=cfg.num_classes,
        att_weights_only=cfg.att_weights_only, seg_if=cfg.seg_if, stereo_if=cfg.stereo_if,
        topk=cfg.topk, refine_topk=cfg.refine_topk, att_window1=cfg.att_window1,
        att_window2=cfg.att_window2, remat=cfg.remat, fuse_views=fuse_views,
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=dtype).eval()


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Reference init: conv kernels normal(0, sqrt(2 / fan_out)) with
    fan_out = prod(kernel) * out_channels; linear kernels lecun-normal; biases
    0; BN/GN scale 1; gamma 0, beta 2 (set by the constructor)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            fan_out = m.weight[0, 0].numel() * m.out_channels
            m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, (1.0 / m.in_features) ** 0.5, generator=gen)
            m.bias.zero_()


__all__ = ["SemStereo", "SemStereoWHU", "FeatUp", "__models__", "build_model", "init_weights"]
