"""3-D hourglass cost aggregation with a windowed-attention bottleneck, and
the 3-D classifier (counterpart of ``semstereo_tpu/nn/hourglass.py``).

Volumes are [B, D, H, W, C].  conv1-conv4 and both classifier convs are
3x3x3 pad-1 convs and run in the Hopper kernel (``ops.conv3d_bn_act``); the
k3 s2 p1 op1 deconvs and 1x1x1 redirs stay on ``F.conv*``.  Given a
``mesh`` that splits the volume, x and the output are this process's slabs
of planes: each conv reads its neighbours' edge planes (``nn/layers.py``),
and the attention gathers the bottleneck whole (``nn/attention.py``).  On
row slabs (``layers.split_rows``) each conv and deconv reads its
neighbours' edge rows along H (axis 2), and the attention keeps to the
slab's windows.  Under both, each conv takes its halo planes, then its
halo rows; the 1x1x1 redirs take the slab as it is.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from semstereo_tpu_torch.nn.attention import WindowedAttention3D
from semstereo_tpu_torch.nn.layers import ConvBn, conv_bn_act


def _convbn_relu(cin, cout, stride):
    """Reference ``Sequential(convbn_3d(...), ReLU)``: weights at ``.0.0``/``.0.1``."""
    return nn.Sequential(ConvBn(cin, cout, 3, stride, 1, dims=3), nn.ReLU())


class Hourglass3D(nn.Module):
    def __init__(self, channels: int, att_window):
        super().__init__()
        c = channels
        self.conv1 = _convbn_relu(c, 2 * c, 2)
        self.conv2 = _convbn_relu(2 * c, 2 * c, 1)
        self.conv3 = _convbn_relu(2 * c, 4 * c, 2)
        self.conv4 = _convbn_relu(4 * c, 4 * c, 1)
        self.attention_block = WindowedAttention3D(4 * c, att_window)
        self.conv5 = ConvBn(4 * c, 2 * c, 3, 2, 1, dims=3, deconv=True, output_padding=1)
        self.conv6 = ConvBn(2 * c, c, 3, 2, 1, dims=3, deconv=True, output_padding=1)
        self.redir1 = ConvBn(c, c, 1, dims=3)
        self.redir2 = ConvBn(2 * c, 2 * c, 1, dims=3)

    def forward(self, x, mesh=None):
        conv1 = self.conv1[0](x, relu=True, mesh=mesh)
        conv2 = self.conv2[0](conv1, relu=True, mesh=mesh)
        conv3 = self.conv3[0](conv2, relu=True, mesh=mesh)
        conv4 = self.conv4[0](conv3, relu=True, mesh=mesh)
        conv4 = self.attention_block(conv4, mesh=mesh)
        conv5 = torch.relu(self.conv5(conv4, mesh=mesh) + self.redir2(conv2, mesh=mesh))
        return torch.relu(self.conv6(conv5, mesh=mesh) + self.redir1(x, mesh=mesh))


class Classifier3D(nn.Sequential):
    """Reference ``Sequential(convbn_3d, ReLU, Conv3d(C -> 1))``; both convs
    run in the kernel (the Cout=1 conv with scale 1, bias 0, no ReLU)."""

    def __init__(self, channels: int):
        super().__init__(
            ConvBn(channels, channels, 3, 1, 1, dims=3),
            nn.ReLU(),
            nn.Conv3d(channels, 1, 3, 1, 1, bias=False),
        )

    def forward(self, x, mesh=None):
        return conv_bn_act(self[2], None, self[0](x, relu=True, mesh=mesh), relu=False,
                           mesh=mesh)
