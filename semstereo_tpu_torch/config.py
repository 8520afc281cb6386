"""Model fields of the presets (a copy of ``semstereo_tpu.config``'s
``ModelConfig`` and ``PRESETS`` model entries; the port keeps its own so that
it imports nothing of the JAX package)."""

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
