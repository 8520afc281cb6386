"""Segmentation head, semantic/feature channel attention on cost volumes and
Semantic Super-Resolution disparity upsampling (counterpart of
``semstereo_tpu/nn/heads.py``), channels-last.  On row slabs
(``layers.split_rows``) the 3x3 convs and the bilinear upsamplings take
their halos (``layers.conv_cl``, ``ops.resize``); the rest is per pixel."""

from __future__ import annotations

import torch
import torch.nn as nn

from semstereo_tpu_torch.nn.layers import BasicConv, BatchNorm, conv_cl, rows_of
from semstereo_tpu_torch.ops.resize import resize_bilinear


class SegmentHead(nn.Module):
    """BasicConv 3x3 -> 1x1 logits -> bilinear x2."""

    def __init__(self, cin: int, interplanes: int, num_classes: int):
        super().__init__()
        self.conv1 = BasicConv(cin, interplanes, 3, 1, 1)
        self.conv2 = nn.Conv2d(interplanes, num_classes, 1)

    def forward(self, x):
        out = conv_cl(self.conv2, self.conv1(x))
        return resize_bilinear(out, (2 * x.shape[1], 2 * x.shape[2]), rows_of(self))


class ChannelAtt(nn.Module):
    """sigmoid channel attention from 2-D features, broadcast over D:
    ``im_att = Sequential(BasicConv 1x1, Conv2d 1x1)``.  On a slab of the
    volume's planes it gates each plane of the slab alike; the gradient it
    sends into the (replicated) features is this slab's part, and the
    gradient all-reduce sums the parts."""

    def __init__(self, cv_channels: int, im_channels: int):
        super().__init__()
        self.im_att = nn.Sequential(
            BasicConv(im_channels, im_channels // 2, 1, 1, 0),
            nn.Conv2d(im_channels // 2, cv_channels, 1),
        )

    def forward(self, cv, im):
        a = conv_cl(self.im_att[1], self.im_att[0](im))
        return torch.sigmoid(a)[:, None] * cv


class SSRUpsample(nn.Module):
    """x4 bilinear disparity plus a residual gated by the predicted semantics
    and the superpixel weights.  Children follow the reference:
    ``conv = Sequential(BN(1), Conv2d(1, nc, 3), BN(nc))``,
    ``conv1``/``conv2 = Sequential(Conv2d 1x1, BN)``, ``conv3`` (nc -> 1)."""

    def __init__(self, num_classes: int):
        super().__init__()
        nc = num_classes
        self.conv = nn.Sequential(BatchNorm(1), nn.Conv2d(1, nc, 3, 1, 1), BatchNorm(nc))
        self.conv1 = nn.Sequential(nn.Conv2d(nc, nc, 1), BatchNorm(nc))
        self.conv2 = nn.Sequential(nn.Conv2d(nc, nc, 1), BatchNorm(nc))
        self.conv3 = nn.Conv2d(nc, 1, 1)

    def forward(self, depth_low, spx_weights, pred_label):
        # depth_low [B, h, w, 1]; spx_weights, pred_label [B, 4h, 4w, nc]
        _, h, w, _ = depth_low.shape
        label_prob = torch.softmax(pred_label, dim=-1)
        depth_up = resize_bilinear(depth_low, (4 * h, 4 * w), rows_of(self))
        d = self.conv[2](conv_cl(self.conv[1], self.conv[0](depth_up)))
        p = torch.sigmoid(self.conv1[1](conv_cl(self.conv1[0], label_prob * spx_weights)))
        p = torch.sigmoid(self.conv2[1](conv_cl(self.conv2[0], p * spx_weights)))
        res = conv_cl(self.conv3, d * p)
        return (depth_up + res)[..., 0]
