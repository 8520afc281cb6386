"""Network blocks of the port (counterpart of ``semstereo_tpu.nn``)."""

from semstereo_tpu_torch.nn.attention import WindowedAttention3D
from semstereo_tpu_torch.nn.backbone import MobileViTv2Backbone
from semstereo_tpu_torch.nn.heads import ChannelAtt, SegmentHead, SSRUpsample
from semstereo_tpu_torch.nn.hourglass import Classifier3D, Hourglass3D
from semstereo_tpu_torch.nn.layers import BasicConv, BatchNorm, Conv2x, ConvBn

__all__ = [
    "WindowedAttention3D", "MobileViTv2Backbone", "ChannelAtt", "SegmentHead",
    "SSRUpsample", "Classifier3D", "Hourglass3D", "BasicConv", "BatchNorm", "Conv2x",
    "ConvBn",
]
