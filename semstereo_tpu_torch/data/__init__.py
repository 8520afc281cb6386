"""Data layer of the port: readers, augmentation, the dataset registry
``__datasets__``, the prefetching loader and the synthetic dataset
(counterpart of ``semstereo_tpu.data``)."""

from semstereo_tpu_torch.data.datasets import (
    CityscapesDataset,
    KittiDataset,
    SceneFlowDataset,
    StereoDataset,
    Us3dDataset,
    WhuDataset,
    __datasets__,
)
from semstereo_tpu_torch.data.loader import DataLoader, SyntheticStereoDataset, collate

__all__ = [
    "CityscapesDataset", "KittiDataset", "SceneFlowDataset", "StereoDataset", "Us3dDataset",
    "WhuDataset", "__datasets__", "DataLoader", "SyntheticStereoDataset", "collate",
]
