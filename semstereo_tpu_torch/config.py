"""Configuration of the port: a copy of what the model, the train step,
the data layer, the trainer and data, disparity and spatial parallelism
read from
``semstereo_tpu.config`` (the port
keeps its own so that it imports nothing of the JAX package).

``TRAIN_PRESETS`` maps each preset name to its whole ``TrainConfig``
(model, data paths and lists, valid-mask policy, optimizer, losses,
logdir); ``PRESETS`` to its ``ModelConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    # Recomputation in the backward pass: False/"none" | True/"full"
    # (backbone + both hourglasses) | a comma-set of {backbone, featup,
    # hourglass, concat, spx} (models/semstereo.py::remat_components).
    remat: bool | str = False
    # A timm mobilevitv2_100 state_dict file loaded into the backbone by
    # init_state, every backbone tensor required (utils/timm_convert.py).
    pretrained_backbone: str | None = None

    @property
    def symmetric(self) -> bool:
        return self.name != "SemStereo_WHU"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "us3d"  # registry key of data.__datasets__
    datapath: str = "data/us3d/JAX"
    trainlist: str = "data/us3d/JAX/train.txt"
    testlist: str = "data/us3d/JAX/test.txt"
    batch_size: int = 4
    test_batch_size: int = 4
    num_workers: int = 4  # loader threads
    prefetch: int = 2  # batches the loader keeps ready
    crop_size: Optional[Tuple[int, int]] = None  # (H, W) train crop, dataset-specific
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
    epochs: int = 48
    # "12,22,30,38,44:2" => divide lr by 2 at each listed epoch (cumulative)
    lrepochs: str = "12,22,30,38,44:2"
    # Microbatches per step: the batch is split into this many chunks, run in
    # turn (BN statistics threaded through), and their gradients averaged.
    grad_accum: int = 1
    # Global-norm gradient clip; 0 disables it.
    grad_clip: float = 0.0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    data: int = -1  # data-parallel processes; -1: the world size
    disp: int = 1  # processes that split the cost volumes' planes (parallel.make_mesh)
    space: int = 1  # processes that split the images' rows (parallel.make_mesh)
    # BatchNorm statistics over the global batch (all-reduced across the
    # data-parallel processes), as GSPMD gives the JAX package.
    sync_bn: bool = True


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
    parallel: ParallelConfig = ParallelConfig()
    loss: LossConfig = LossConfig()
    seed: int = 1
    logdir: str = "checkpoints/run"
    loadckpt: str = ""  # partial warm start (stage 1 -> stage 2)
    resume: bool = False
    summary_freq: int = 50
    save_freq: int = 4  # epochs between checkpoints
    compute_dtype: str = "float32"  # float32 | bfloat16 (model compute)
    # Seg-metric aggregation: False derives PA/MPA/mIoU from one confusion
    # matrix over the eval set; True averages per-batch values through the
    # NaN-skipping per-key meter (the original torch code's logs).
    eval_seg_per_batch: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def _us3d(stage1: bool) -> TrainConfig:
    return TrainConfig(
        model=ModelConfig(maxdisp=64, att_weights_only=stage1),
        data=DataConfig(dataset="us3d"),
        loss=LossConfig(use_seg=True, use_lrsc=True),
        logdir=f"checkpoints/us3d_stage{1 if stage1 else 2}",
    )


def _whu(stage1: bool, lrsc_self: bool) -> TrainConfig:
    tag = "whu_lrsc" if lrsc_self else "whu"
    return TrainConfig(
        model=ModelConfig(name="SemStereo_WHU", maxdisp=128, att_weights_only=stage1),
        data=DataConfig(dataset="WhuDataset", datapath="data/whu",
                        trainlist="data/whu/train.txt", testlist="data/whu/test.txt"),
        loss=LossConfig(use_seg=False, use_lrsc=False, use_lrsc_self=lrsc_self),
        logdir=f"checkpoints/{tag}_stage{1 if stage1 else 2}",
    )


def _cropped(dataset: str, trainlist: str, testlist: str, num_classes: int,
             loss: LossConfig) -> TrainConfig:
    """SceneFlow, KITTI and Cityscapes: 256x512 train crops."""
    return TrainConfig(
        model=ModelConfig(maxdisp=64, num_classes=num_classes),
        data=DataConfig(dataset=dataset, datapath=f"data/{dataset}",
                        trainlist=f"filenames/{trainlist}", testlist=f"filenames/{testlist}",
                        crop_size=(256, 512)),
        loss=loss,
        logdir=f"checkpoints/{dataset}",
    )


# KITTI and Cityscapes: 19 classes and the ignore class 19.
_SEG_LRSC_19 = LossConfig(use_seg=True, use_lrsc=True, ignore_index=19)
TRAIN_PRESETS = {
    "us3d_stage1": _us3d(True),
    "us3d_stage2": _us3d(False),
    "whu_stage1": _whu(True, False),
    "whu_stage2": _whu(False, False),
    "whu_lrsc_stage1": _whu(True, True),
    "whu_lrsc_stage2": _whu(False, True),
    "sceneflow": _cropped("sceneflow", "sceneflow_train.txt", "sceneflow_test.txt", 6,
                          LossConfig(use_seg=False, use_lrsc=False)),
    "kitti": _cropped("kitti", "kitti15_train.txt", "kitti15_val.txt", 20, _SEG_LRSC_19),
    "cityscapes": _cropped("cityscapes", "cityscapes_train.txt", "cityscapes_val.txt", 20,
                           _SEG_LRSC_19),
}
PRESETS = {name: cfg.model for name, cfg in TRAIN_PRESETS.items()}


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
