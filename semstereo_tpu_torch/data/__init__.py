"""Data of the port: the synthetic stereo dataset."""

from semstereo_tpu_torch.data.synthetic import SyntheticStereoDataset

__all__ = ["SyntheticStereoDataset"]
