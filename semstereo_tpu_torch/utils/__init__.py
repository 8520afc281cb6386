"""Experiment utilities of the port: meters, writers, visualization, the
stdout tee (counterpart of ``semstereo_tpu.utils``)."""

from semstereo_tpu_torch.utils.experiment import (
    AverageMeterDict,
    AverageMeterDictPerKey,
    TeeLogger,
    save_images,
    save_scalars,
    tensor2float,
    tensor2numpy,
)
from semstereo_tpu_torch.utils.visualization import disp_error_image, label_vis

__all__ = [
    "AverageMeterDict", "AverageMeterDictPerKey", "TeeLogger", "save_images",
    "save_scalars", "tensor2float", "tensor2numpy", "disp_error_image", "label_vis",
]
