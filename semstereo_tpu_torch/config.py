"""Configuration of the port: a copy of what the model and the train step
read from ``semstereo_tpu.config`` (the port keeps its own so that it
imports nothing of the JAX package).

``PRESETS`` maps each preset name to its ``ModelConfig``; ``TRAIN_PRESETS``
to its whole ``TrainConfig`` (model, valid-mask policy, optimizer, losses).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Fused-pyramid channel plan (FeatUp outputs) and its chal_* reductions.
CHANS = (128, 256, 512, 768, 512)
CHANS2 = (64, 128, 256, 384, 256)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "SemStereo"  # registry key: SemStereo | SemStereo_WHU
    maxdisp: int = 64
    num_classes: int = 6
    att_weights_only: bool = False
    seg_if: bool = True
    stereo_if: bool = True
    topk: int = 24
    refine_topk: int = 2
    att_window1: Tuple[int, int, int] = (4, 4, 4)
    att_window2: Tuple[int, int, int] = (6, 4, 4)

    @property
    def symmetric(self) -> bool:
        return self.name != "SemStereo_WHU"


PRESETS = {
    "us3d_stage1": ModelConfig(maxdisp=64, att_weights_only=True),
    "us3d_stage2": ModelConfig(maxdisp=64),
    "whu_stage1": ModelConfig(name="SemStereo_WHU", maxdisp=128, att_weights_only=True),
    "whu_stage2": ModelConfig(name="SemStereo_WHU", maxdisp=128),
    "whu_lrsc_stage1": ModelConfig(name="SemStereo_WHU", maxdisp=128, att_weights_only=True),
    "whu_lrsc_stage2": ModelConfig(name="SemStereo_WHU", maxdisp=128),
    "sceneflow": ModelConfig(maxdisp=64),
    "kitti": ModelConfig(maxdisp=64, num_classes=20),
    "cityscapes": ModelConfig(maxdisp=64, num_classes=20),
}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "us3d"
    # Valid-disparity mask of the losses and metrics: 'symmetric' ->
    # -maxdisp <= d < maxdisp (US3D); 'positive' -> 0 < d < maxdisp (WHU,
    # and KITTI-style disparity maps where 0 means no ground truth);
    # 'auto' -> symmetric for the us3d dataset with a symmetric model, else
    # positive.
    mask_policy: str = "auto"

    def resolved_mask_policy(self, symmetric_model: bool) -> str:
        if self.mask_policy != "auto":
            return self.mask_policy
        return "symmetric" if (symmetric_model and self.dataset == "us3d") else "positive"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    # "12,22,30,38,44:2" => divide lr by 2 at each listed epoch (cumulative)
    lrepochs: str = "12,22,30,38,44:2"
    # Microbatches per step: the batch is split into this many chunks, run in
    # turn (BN statistics threaded through), and their gradients averaged.
    grad_accum: int = 1
    # Global-norm gradient clip; 0 disables it.
    grad_clip: float = 0.0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    use_seg: bool = True  # supervised label loss on the left head
    use_lrsc: bool = True  # LRSC cross-entropy on the right head (ground-truth left labels)
    use_lrsc_self: bool = False  # LRSC with the predicted left labels
    ignore_index: int = 5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    optim: OptimConfig = OptimConfig()
    loss: LossConfig = LossConfig()
    seed: int = 1
    compute_dtype: str = "float32"  # float32 | bfloat16 (model compute)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def _train(name: str, dataset: str, loss: LossConfig) -> TrainConfig:
    return TrainConfig(model=PRESETS[name], data=DataConfig(dataset=dataset), loss=loss)


_WHU_LOSS = LossConfig(use_seg=False, use_lrsc=False)
_SEG_LRSC_19 = LossConfig(use_seg=True, use_lrsc=True, ignore_index=19)
TRAIN_PRESETS = {
    "us3d_stage1": _train("us3d_stage1", "us3d", LossConfig()),
    "us3d_stage2": _train("us3d_stage2", "us3d", LossConfig()),
    "whu_stage1": _train("whu_stage1", "WhuDataset", _WHU_LOSS),
    "whu_stage2": _train("whu_stage2", "WhuDataset", _WHU_LOSS),
    "whu_lrsc_stage1": _train("whu_lrsc_stage1", "WhuDataset",
                              LossConfig(use_seg=False, use_lrsc=False, use_lrsc_self=True)),
    "whu_lrsc_stage2": _train("whu_lrsc_stage2", "WhuDataset",
                              LossConfig(use_seg=False, use_lrsc=False, use_lrsc_self=True)),
    "sceneflow": _train("sceneflow", "sceneflow", LossConfig(use_seg=False, use_lrsc=False)),
    "kitti": _train("kitti", "kitti", _SEG_LRSC_19),
    "cityscapes": _train("cityscapes", "cityscapes", _SEG_LRSC_19),
}


def parse_lrepochs(spec: str) -> tuple[list[int], float]:
    """"12,22,30,38,44:2" -> ([12, 22, 30, 38, 44], 2.0)."""
    epochs_str, rate_str = spec.split(":")
    return [int(e) for e in epochs_str.split(",")], float(rate_str)


def lr_for_epoch(base_lr: float, epoch: int, spec: str) -> float:
    """The piecewise-constant learning rate of ``epoch``."""
    downs, rate = parse_lrepochs(spec)
    lr = base_lr
    for e in downs:
        if epoch >= e:
            lr /= rate
        else:
            break
    return lr
