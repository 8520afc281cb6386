"""Tensor ops of the port (channels-last, as in ``semstereo_tpu.ops``)."""

from semstereo_tpu_torch.ops.conv3d import conv3d_bn_act, conv3d_bn_act_plain
from semstereo_tpu_torch.ops.cost_volume import (
    gwc_volume_norm,
    gwc_volume_norm_plain,
    normalize_groups,
)
from semstereo_tpu_torch.ops.propagation import propagate5, propagate5_volume
from semstereo_tpu_torch.ops.regression import (
    disparity_regression,
    disparity_values,
    disparity_variance,
    regression_topk,
    topk_planes,
)
from semstereo_tpu_torch.ops.resize import resize_bilinear, resize_trilinear
from semstereo_tpu_torch.ops.warp import disparity_warp, warp_strength, warp_with_left

__all__ = [
    "conv3d_bn_act", "conv3d_bn_act_plain", "gwc_volume_norm", "gwc_volume_norm_plain",
    "normalize_groups", "propagate5", "propagate5_volume", "disparity_regression",
    "disparity_values", "disparity_variance", "regression_topk", "topk_planes",
    "resize_bilinear", "resize_trilinear", "disparity_warp", "warp_strength",
    "warp_with_left",
]
