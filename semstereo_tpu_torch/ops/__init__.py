"""Tensor ops of the port (channels-last, as in ``semstereo_tpu.ops``).

The differentiable volume conv is ``semstereo_tpu_torch.ops.conv3d.conv3d``
(not re-exported here, where its name would hide the module)."""

from semstereo_tpu_torch.ops.conv3d import (
    conv3d_bn_act,
    conv3d_bn_act_plain,
    conv3d_input_grad_s1,
    conv3d_plain,
    conv3d_weight_grad,
)
from semstereo_tpu_torch.ops.cost_volume import (
    gwc_volume_norm,
    gwc_volume_norm_bwd,
    gwc_volume_norm_bwd_plain,
    gwc_volume_norm_plain,
    normalize_groups,
)
from semstereo_tpu_torch.ops.propagation import propagate5, propagate5_volume
from semstereo_tpu_torch.ops.regression import (
    disparity_regression,
    disparity_values,
    disparity_variance,
    regression_topk,
    topk_plane_indices,
    topk_planes,
)
from semstereo_tpu_torch.ops.resize import resize_bilinear, resize_trilinear
from semstereo_tpu_torch.ops.warp import (
    disparity_warp,
    lrsc_label_warp,
    warp_strength,
    warp_with_left,
)



def launch_counts() -> dict:
    """The hand kernels' launches since the last ``reset_launch_counts``:
    K1 by stride, K2, the K1 launches made as K3's stride-1 dx, K3's dw and
    K4.  Each wrapper counts where it launches its kernel, so on CPU
    tensors (the plain versions) every count stays 0."""
    return {"K1-s1": conv3d_bn_act.launches_s1, "K1-s2": conv3d_bn_act.launches_s2,
            "K2": gwc_volume_norm.launches, "K3": conv3d_input_grad_s1.launches,
            "K3-dw": conv3d_weight_grad.launches, "K4": gwc_volume_norm_bwd.launches}


def reset_launch_counts() -> None:
    """Sets every launch count to 0, and K2's and K4's planes and rows."""
    conv3d_bn_act.launches_s1 = conv3d_bn_act.launches_s2 = 0
    conv3d_input_grad_s1.launches = conv3d_weight_grad.launches = 0
    for kernel in (gwc_volume_norm, gwc_volume_norm_bwd):
        kernel.launches = kernel.planes = kernel.rows = 0


__all__ = [
    "conv3d_bn_act", "conv3d_bn_act_plain", "conv3d_plain", "gwc_volume_norm",
    "gwc_volume_norm_bwd", "gwc_volume_norm_bwd_plain", "gwc_volume_norm_plain",
    "normalize_groups", "propagate5", "propagate5_volume", "disparity_regression",
    "disparity_values", "disparity_variance", "regression_topk", "topk_plane_indices",
    "topk_planes",
    "resize_bilinear", "resize_trilinear", "disparity_warp", "lrsc_label_warp",
    "warp_strength", "warp_with_left", "launch_counts", "reset_launch_counts",
]
