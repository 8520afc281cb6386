"""Train state: the fp32 master model with its BN buffers, and the Adam
optimizer (counterpart of ``semstereo_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses

import torch

from semstereo_tpu_torch.config import TrainConfig, lr_for_epoch
from semstereo_tpu_torch.models import SemStereo, build_model
from semstereo_tpu_torch.utils.timm_convert import load_and_merge


@dataclasses.dataclass
class TrainState:
    model: SemStereo  # fp32 master parameters and fp32 BN running statistics
    optimizer: torch.optim.Optimizer
    epoch: int = 0


def build_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """Adam with the config's learning rate and betas and eps 1e-8, which
    is optax's ``adam``.  The global-norm clip (``cfg.optim.grad_clip``) is
    applied by the train step before ``step()``."""
    return torch.optim.Adam(params, lr=cfg.optim.lr, betas=tuple(cfg.optim.betas), eps=1e-8)


def init_state(cfg: TrainConfig, device="cuda") -> TrainState:
    """A fresh state: the model of ``cfg.model`` on ``device`` (the card
    unless the caller asks for the CPU) in train mode, with weights drawn
    from ``cfg.seed`` and, when ``cfg.model.pretrained_backbone`` names a
    timm checkpoint, its backbone loaded from it; and its optimizer."""
    model = build_model(cfg.model, device=device, seed=cfg.seed).train()
    if cfg.model.pretrained_backbone:
        n = load_and_merge(cfg.model.pretrained_backbone, model)
        print(f"loaded pretrained backbone: {n} leaves from {cfg.model.pretrained_backbone}")
    return TrainState(model=model, optimizer=build_optimizer(cfg, model.parameters()))


def set_learning_rate(state: TrainState, cfg: TrainConfig, epoch: int) -> TrainState:
    """Apply the epoch's piecewise-constant learning rate."""
    lr = lr_for_epoch(cfg.optim.lr, epoch, cfg.optim.lrepochs)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.epoch = epoch
    return state


def merge_partial_params(current: dict, loaded: dict) -> tuple[dict, int]:
    """Filtered partial load of a state_dict: each entry of ``current``
    whose key is in ``loaded`` with the same shape takes the loaded value
    (cast to the current dtype); the rest stay.  Returns (merged, number of
    entries taken) — the stage-1 -> stage-2 warm start."""
    merged, n_loaded = {}, 0
    for key, cur in current.items():
        cand = loaded.get(key)
        if cand is not None and tuple(cand.shape) == tuple(cur.shape):
            merged[key] = cand.to(cur.dtype)
            n_loaded += 1
        else:
            merged[key] = cur
    return merged, n_loaded
