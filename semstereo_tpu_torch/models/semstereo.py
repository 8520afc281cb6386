"""SemStereo, train and eval forward (counterpart of
``semstereo_tpu/models/semstereo.py``).

Layouts: images [B, H, W, C]; volumes [B, D, H, W, C]; hypothesis maps
[B, K, H, W].  Module names reproduce the reference torch state-dict keys
(``feature_up.deconv32_16.conv1.conv.weight``, ``hourglass.conv1.0.0.weight``,
``classif_att_.2.weight``, ...), which ``convert.py`` and the JAX package's
``utils/torch_convert.py`` both read.

Output (dict), each disparity [B, H, W]:
  train, stage 2:  disp = (pred_up*4, pred*4, pred_att_up*4, pred_att*4)
  train, stage 1:  disp = (pred_att_up*4, pred_att*4)  (``att_weights_only``)
  eval:            disp = (pred_up*4,)  [or pred_att_up in stage 1]
  seg_if adds      label_l, label_r: [B, H, W, num_classes] logits.
The two views go through the shared front end in two passes, left then
right; in train mode each pass normalises with its own batch statistics and
moves the running statistics in turn, as flax's mutable ``batch_stats``
does.  Eval runs under ``torch.inference_mode``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from semstereo_tpu_torch.config import CHANS, CHANS2
from semstereo_tpu_torch.nn import (
    BasicConv,
    ChannelAtt,
    Classifier3D,
    Conv2x,
    ConvBn,
    Hourglass3D,
    MobileViTv2Backbone,
    SegmentHead,
    SSRUpsample,
)
from semstereo_tpu_torch.nn.layers import conv_cl
from semstereo_tpu_torch.ops import (
    disparity_regression,
    disparity_variance,
    gwc_volume_norm,
    propagate5,
    propagate5_volume,
    regression_topk,
    resize_trilinear,
    topk_planes,
    warp_strength,
    warp_with_left,
)


class FeatUp(nn.Module):
    """Top-down FPN of deconv Conv2x stages over one pyramid."""

    def __init__(self):
        super().__init__()
        # backbone channels (64, 128, 256, 384, 512) -> CHANS
        self.deconv32_16 = Conv2x(512, 384)
        self.deconv16_8 = Conv2x(2 * 384, 256)
        self.deconv8_4 = Conv2x(2 * 256, 128)
        self.deconv4_2 = Conv2x(2 * 128, 64)

    def forward(self, feats):
        x2, x4, x8, x16, x32 = feats
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.deconv8_4(x8, x4)
        x2 = self.deconv4_2(x4, x2)
        return [x2, x4, x8, x16, x32]


class _ConcatFeature(nn.Sequential):
    """BasicConv 3x3 (128 -> 64) + plain 3x3 conv to 32 channels."""

    def __init__(self):
        super().__init__(
            BasicConv(CHANS2[1], CHANS2[1] // 2, 3, 1, 1),
            nn.Conv2d(CHANS2[1] // 2, CHANS2[1] // 4, 3, 1, 1, bias=False),
        )

    def forward(self, x):
        return conv_cl(self[1], self[0](x))


class SemStereo(nn.Module):
    def __init__(self, maxdisp: int = 64, num_classes: int = 6, att_weights_only: bool = False,
                 seg_if: bool = True, stereo_if: bool = True, symmetric: bool = True,
                 topk: int = 24, refine_topk: int = 2, att_window1=(4, 4, 4),
                 att_window2=(6, 4, 4)):
        super().__init__()
        if stereo_if and not seg_if:
            raise ValueError("stereo_if requires seg_if: SSR upsampling consumes pred_label")
        d8 = maxdisp // 8 * (2 if symmetric else 1)
        if d8 % 4:
            raise ValueError(
                f"maxdisp={maxdisp} gives a {d8}-plane /8 attention volume; the hourglass "
                "needs D divisible by 4 (two stride-2 halvings), so maxdisp must be a "
                f"multiple of {16 if symmetric else 32}"
            )
        self.maxdisp = maxdisp
        self.num_classes = num_classes
        self.att_weights_only = att_weights_only
        self.seg_if = seg_if
        self.stereo_if = stereo_if
        self.symmetric = symmetric
        self.topk = topk
        self.refine_topk = refine_topk

        self.feature = MobileViTv2Backbone()
        self.feature_up = FeatUp()
        if seg_if:
            self.head_l = SegmentHead(CHANS[0], CHANS[0] // 4, num_classes)
            self.head_r = SegmentHead(CHANS[0], CHANS[0] // 4, num_classes)
        if not stereo_if:
            return
        for i in range(5):
            self.add_module(f"chal_{i}", ConvBn(CHANS[i], CHANS2[i], 1, bias=True))
        self.spx32_16 = Conv2x(CHANS2[4], CHANS2[3])
        self.spx16_8 = Conv2x(CHANS2[3] * 2, CHANS2[2])
        self.spx8_4 = Conv2x(CHANS2[2] * 2, CHANS2[1])
        self.spx4_2 = Conv2x(CHANS2[1] * 2, CHANS2[0])
        self.spx2 = nn.Sequential(nn.ConvTranspose2d(CHANS2[0] * 2, num_classes, 4, 2, 1))
        groups = CHANS2[2] // 8  # 32
        self.patch = nn.Conv3d(groups, groups, (1, 3, 3), 1, (0, 1, 1), groups=groups,
                               bias=False)
        self.corr_feature_att_8 = ChannelAtt(groups, CHANS2[2])
        self.hourglass_att = Hourglass3D(32, att_window1)
        self.classif_att_ = Classifier3D(32)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.beta = nn.Parameter(torch.full((1,), 2.0))
        self.ssr_upsample = SSRUpsample(num_classes)
        if not att_weights_only:
            self.concat_feature = _ConcatFeature()
            self.concat_stem = BasicConv(CHANS2[1] // 2, CHANS2[1] // 4, 3, 1, 1, dims=3)
            self.concat_feature_att_4 = ChannelAtt(CHANS2[1] // 4, CHANS2[1])
            self.hourglass = Hourglass3D(32, att_window2)
            self.classif = Classifier3D(32)

    def _chal(self, i, x):
        return getattr(self, f"chal_{i}")(x)

    def forward(self, left, right):
        """left, right [B, H, W, 3] -> dict (see the module docstring)."""
        if self.training:
            return self._forward(left, right)
        with torch.inference_mode():
            return self._forward(left, right)

    def _forward(self, left, right):
        train = self.training
        feat_l = self.feature_up(self.feature(left))
        feat_r = self.feature_up(self.feature(right))
        out = {}
        if self.seg_if:
            pred_label = self.head_l(feat_l[0])
            out["label_l"] = pred_label
            out["label_r"] = self.head_r(feat_r[0])
        if not self.stereo_if:
            return out

        fl = [self._chal(i, feat_l[i]) for i in range(5)]
        fr1 = self._chal(1, feat_r[1])
        fr2 = self._chal(2, feat_r[2])

        xspx = self.spx32_16(fl[4], fl[3])
        xspx = self.spx16_8(xspx, fl[2])
        xspx = self.spx8_4(xspx, fl[1])
        xspx = self.spx4_2(xspx, fl[0])
        spx_pred = conv_cl(self.spx2[0], xspx)

        # stage 1: cosine GWC attention volume at /8
        groups = CHANS2[2] // 8
        corr = gwc_volume_norm(fl[2].contiguous(), fr2.contiguous(), self.maxdisp // 8, groups,
                               symmetric=self.symmetric)  # [B, D8, H8, W8, G]
        corr = conv_cl(self.patch, corr)
        cost_att = self.corr_feature_att_8(corr, fl[2])
        cost_att = self.hourglass_att(cost_att)
        cost_att = self.classif_att_(cost_att)

        d4 = self.maxdisp // 4 * (2 if self.symmetric else 1)
        h4, w4 = left.shape[1] // 4, left.shape[2] // 4
        att_weights = resize_trilinear(cost_att, (d4, h4, w4))[..., 0]  # [B, D4, H4, W4]
        att_prob_full = torch.softmax(att_weights, dim=1)
        pred_att = disparity_regression(att_prob_full, self.symmetric)

        var = disparity_variance(att_prob_full, pred_att, self.symmetric)
        conf = torch.sigmoid(self.beta[0] + self.gamma[0] * var)
        conf_samples = propagate5(conf)
        disp_samples = propagate5(pred_att)

        if self.symmetric:
            min_off, max_off = -(d4 // 2), d4 // 2
        else:
            min_off, max_off = -d4, 0
        strength = warp_strength(fl[1], fr1, disp_samples, max_off, min_off)
        strength = torch.softmax(strength * conf_samples, dim=1)

        att_weights = propagate5_volume(att_weights)  # [B, 5, D4, H4, W4]
        att_weights = torch.sum(att_weights * strength[:, :, None], dim=1)

        k = min(self.topk, d4)
        att_topk, att_raw, samples = topk_planes(att_weights, k, self.symmetric)
        att_prob = torch.softmax(att_raw, dim=1)
        pred_att = torch.sum(att_prob * samples, dim=1)
        if self.att_weights_only or train:
            pred_att_up = self.ssr_upsample(pred_att[..., None], spx_pred, pred_label)
        if self.att_weights_only:
            out["disp"] = (pred_att_up * 4, pred_att * 4) if train else (pred_att_up * 4,)
            return out

        # stage 2: top-k sampled concat volume at /4
        lc = self.concat_feature(fl[1])
        rc = self.concat_feature(fr1)
        warped_rc, tiled_lc = warp_with_left(lc, rc, samples)
        # att * concat(tiled left, warped right): [B, K, H4, W4, 64]; eval
        # writes it in place, which autograd cannot follow
        if train:
            volume = att_topk[..., None] * torch.cat([tiled_lc, warped_rc], dim=-1)
        else:
            c = lc.shape[-1]
            volume = torch.empty((*warped_rc.shape[:-1], 2 * c), dtype=lc.dtype,
                                 device=lc.device)
            torch.mul(att_topk[..., None], tiled_lc, out=volume[..., :c])
            torch.mul(att_topk[..., None], warped_rc, out=volume[..., c:])
        volume = self.concat_stem(volume)
        volume = self.concat_feature_att_4(volume, fl[1])
        cost = self.hourglass(volume)
        cost = self.classif(cost)[..., 0]
        pred = regression_topk(cost, samples, self.refine_topk)
        pred_up = self.ssr_upsample(pred[..., None], spx_pred, pred_label)
        if train:
            out["disp"] = (pred_up * 4, pred * 4, pred_att_up * 4, pred_att * 4)
        else:
            out["disp"] = (pred_up * 4,)
        return out
