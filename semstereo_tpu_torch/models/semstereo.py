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
does.  Eval runs under ``torch.inference_mode``; with ``fuse_views`` it
stacks the two views into one batch through ``feature``, ``feature_up``,
``chal_1``, ``chal_2`` and ``concat_feature`` (BatchNorm uses its running
statistics there, so the result is the two-pass one).  Train ignores it.

``remat`` recomputes the chosen components' forwards in the backward
instead of keeping their activations (``remat_components``), each under
``torch.utils.checkpoint`` (non-reentrant).  The checkpointed function
takes the parameters it uses as inputs and binds them with
``functional_call``, so the recomputation uses the tensors the forward used
(the bf16 casts of the train step's ``functional_call``, not the fp32
masters it has put back by then); BatchNorm does not move its running
statistics in the recomputation.

Disparity parallelism (``mesh``, from ``parallel.make_mesh``, with a disp
axis above 1): the processes of a disp group hold the same rows and run
everything outside the two cost-volume pipelines whole, alike; each holds
one slab of the planes from the cost volume to the classifier's output
(the JAX package's ``_constrain_disp`` sites).  Stage 1: K2 builds the
process's slab of the /8 volume, the patch conv, channel attention,
``hourglass_att`` and ``classif_att_`` run on it, and the classifier's
output is gathered before the trilinear resize.  The group's first process
chooses the top-k planes and broadcasts the choice (a near-tie rounded
otherwise in one process would tear the slabs apart).  Stage 2: each
process builds its slab of the top-k concat volume, runs ``concat_stem``
to ``classif`` on it and gathers ``cost`` before the top-k regression.

Spatial parallelism (``mesh`` with a space axis above 1, the JAX package's
``shard_spatial``): ``left`` and ``right`` are this process's slab of the
images' rows, and every layer computes its rows of its output, down to the
disparity and the label logits, which are the process's rows of the
whole.  ``layers.split_rows`` gives every submodule the mesh, so each conv
and deconv takes its halo rows, GroupNorm and the separable attention
their statistics over the space group, and the hourglass attention keeps
to its slab's windows.  In this module: the bilinear and trilinear
upsamplings and the 5-tap propagations take their halos
(``ops.resize``, ``ops.propagation``).  The cosine volume (K2 and its VJP
K4) correlates along W only, so each process builds it from its rows, with
no halo; ``warp_strength``, ``disparity_warp``, the soft-argmin, the
variance and the top-k choices are per row or per pixel.  The forward
checks the slab's rows against ``parallel.check_space_rows``.

Both together (a mesh with disp and space above 1, JAX's ``shard_disp``
with ``shard_spatial``): each process holds its slab of rows of
everything, and of the cost volumes one slab of planes of those rows.  K2
builds its planes of its rows; the volume convs take halos along D and H
(``nn/layers.py``); ``gather_planes`` of ``cost_att`` and of ``cost``
runs within the row slab's disp group, so the trilinear resize, the
propagations and the top-k regression run on every plane of the row slab,
with row halos; the top-k choice is broadcast within that disp group, and
the stage-2 plane slab is cut from the row slab's choice.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

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
from semstereo_tpu_torch.nn.layers import conv_cl, recomputing, rows_of, split_rows
from semstereo_tpu_torch.parallel import (
    broadcast_from_group,
    check_disp_planes,
    check_space_rows,
    gather_planes,
    volume_planes,
)
from semstereo_tpu_torch.ops import (
    disparity_regression,
    disparity_variance,
    gwc_volume_norm,
    propagate5,
    propagate5_volume,
    regression_topk,
    resize_trilinear,
    topk_plane_indices,
    topk_planes,
    warp_strength,
    warp_with_left,
)


REMAT_COMPONENTS = ("backbone", "featup", "hourglass", "concat", "spx")


def remat_components(spec) -> frozenset:
    """The components a remat spec recomputes: False/None/""/"none" none;
    True/"full" the backbone and both hourglasses; else a comma-set of
    ``REMAT_COMPONENTS``."""
    if spec in (False, None, "", "none"):
        return frozenset()
    if spec is True or spec == "full":
        return frozenset({"backbone", "hourglass"})
    comps = frozenset(s.strip() for s in str(spec).split(",") if s.strip())
    unknown = comps - set(REMAT_COMPONENTS)
    if unknown:
        raise ValueError(f"unknown remat components: {sorted(unknown)}")
    return comps


def _checkpointed(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` under a non-reentrant checkpoint whose
    function takes the module's parameters (as bound now) as inputs; the
    recomputation runs under ``recomputing()``."""
    names, tensors = zip(*module.named_parameters())

    def run(*inputs):
        return functional_call(module, dict(zip(names, inputs[len(args):])), inputs[:len(args)],
                               kwargs)

    return checkpoint(run, *args, *tensors, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), recomputing()))


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
                 att_window2=(6, 4, 4), remat=False, fuse_views=None, mesh=None):
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
        self.remat = remat_components(remat)
        self.fuse_views = fuse_views
        self.att_window1, self.att_window2 = tuple(att_window1), tuple(att_window2)
        # the plane split (module docstring); not a submodule or a buffer
        self.mesh = mesh if mesh is not None and mesh.split else None
        if self.mesh is not None:
            check_disp_planes(volume_planes(maxdisp, symmetric, topk, att_weights_only),
                              mesh.disp)
        self._build()
        split_rows(self, mesh)

    def _build(self):
        """The submodules (reference state-dict names)."""
        num_classes, att_weights_only = self.num_classes, self.att_weights_only

        self.feature = MobileViTv2Backbone()
        self.feature_up = FeatUp()
        if self.seg_if:
            self.head_l = SegmentHead(CHANS[0], CHANS[0] // 4, num_classes)
            self.head_r = SegmentHead(CHANS[0], CHANS[0] // 4, num_classes)
        if not self.stereo_if:
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
        self.hourglass_att = Hourglass3D(32, self.att_window1)
        self.classif_att_ = Classifier3D(32)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.beta = nn.Parameter(torch.full((1,), 2.0))
        self.ssr_upsample = SSRUpsample(num_classes)
        if not att_weights_only:
            self.concat_feature = _ConcatFeature()
            self.concat_stem = BasicConv(CHANS2[1] // 2, CHANS2[1] // 4, 3, 1, 1, dims=3)
            self.concat_feature_att_4 = ChannelAtt(CHANS2[1] // 4, CHANS2[1])
            self.hourglass = Hourglass3D(32, self.att_window2)
            self.classif = Classifier3D(32)

    def _chal(self, i, x):
        return getattr(self, f"chal_{i}")(x)

    def _call(self, component: str, module: nn.Module, *args, **kwargs):
        """``module(*args, **kwargs)``, recomputed in the backward when
        ``component`` is in ``remat`` and a gradient is being recorded."""
        if component in self.remat and self.training and torch.is_grad_enabled():
            return _checkpointed(module, *args, **kwargs)
        return module(*args, **kwargs)

    def forward(self, left, right):
        """left, right [B, H, W, 3] -> dict (see the module docstring)."""
        if self.training:
            return self._forward(left, right)
        with torch.inference_mode():
            return self._forward(left, right)

    def _front(self, x):
        return self._call("featup", self.feature_up, self._call("backbone", self.feature, x))

    def _forward(self, left, right):
        train = self.training
        rows = rows_of(self)
        if rows is not None:
            check_space_rows(left.shape[1] * rows.space, rows.space, self)
        b = left.shape[0]
        fuse = bool(self.fuse_views) and not train
        if fuse:
            feats = self._front(torch.cat([left, right]))
            feat_l = [f[:b] for f in feats]
            feat_r = [f[b:] for f in feats]
        else:
            feat_l = self._front(left)
            feat_r = self._front(right)
        out = {}
        if self.seg_if:
            pred_label = self.head_l(feat_l[0])
            out["label_l"] = pred_label
            out["label_r"] = self.head_r(feat_r[0])
        if not self.stereo_if:
            return out

        if fuse:  # levels 1 and 2 feed both views: reduce the stacked batch
            c1, c2 = self._chal(1, feats[1]), self._chal(2, feats[2])
            fl = [self._chal(0, feat_l[0]), c1[:b], c2[:b], self._chal(3, feat_l[3]),
                  self._chal(4, feat_l[4])]
            fr1, fr2 = c1[b:], c2[b:]
        else:
            fl = [self._chal(i, feat_l[i]) for i in range(5)]
            fr1 = self._chal(1, feat_r[1])
            fr2 = self._chal(2, feat_r[2])

        xspx = self._call("spx", self.spx32_16, fl[4], fl[3])
        xspx = self._call("spx", self.spx16_8, xspx, fl[2])
        xspx = self._call("spx", self.spx8_4, xspx, fl[1])
        xspx = self._call("spx", self.spx4_2, xspx, fl[0])
        spx_pred = conv_cl(self.spx2[0], xspx)

        # stage 1: cosine GWC attention volume at /8 (this process's slab
        # of its planes under a mesh)
        mesh = self.mesh
        groups = CHANS2[2] // 8
        d8 = self.maxdisp // 8 * (2 if self.symmetric else 1)
        p8, n8 = mesh.slab(d8) if mesh is not None else (0, None)
        corr = gwc_volume_norm(fl[2].contiguous(), fr2.contiguous(), self.maxdisp // 8, groups,
                               self.symmetric, p8, n8)  # [B, D8, H8, W8, G]
        corr = conv_cl(self.patch, corr)
        cost_att = self.corr_feature_att_8(corr, fl[2])
        cost_att = self._call("hourglass", self.hourglass_att, cost_att, mesh=mesh)
        cost_att = self.classif_att_(cost_att, mesh=mesh)
        if mesh is not None:
            cost_att = gather_planes(cost_att, mesh)

        d4 = self.maxdisp // 4 * (2 if self.symmetric else 1)
        h4, w4 = left.shape[1] // 4, left.shape[2] // 4
        att_weights = resize_trilinear(cost_att, (d4, h4, w4), rows)[..., 0]  # [B, D4, H4, W4]
        att_prob_full = torch.softmax(att_weights, dim=1)
        pred_att = disparity_regression(att_prob_full, self.symmetric)

        var = disparity_variance(att_prob_full, pred_att, self.symmetric)
        conf = torch.sigmoid(self.beta[0] + self.gamma[0] * var)
        conf_samples = propagate5(conf, rows)
        disp_samples = propagate5(pred_att, rows)

        if self.symmetric:
            min_off, max_off = -(d4 // 2), d4 // 2
        else:
            min_off, max_off = -d4, 0
        strength = warp_strength(fl[1], fr1, disp_samples, max_off, min_off)
        strength = torch.softmax(strength * conf_samples, dim=1)

        att_weights = propagate5_volume(att_weights, rows)  # [B, 5, D4, H4, W4]
        att_weights = torch.sum(att_weights * strength[:, :, None], dim=1)

        k = min(self.topk, d4)
        ind = topk_plane_indices(att_weights, k)
        if mesh is not None:  # one choice of planes for the group's slabs, a byte each
            ind = broadcast_from_group(ind.to(torch.uint8 if d4 <= 256 else torch.int32),
                                       mesh).long()
        att_topk, att_raw, samples = topk_planes(att_weights, k, self.symmetric, ind)
        att_prob = torch.softmax(att_raw, dim=1)
        pred_att = torch.sum(att_prob * samples, dim=1)
        if self.att_weights_only or train:
            pred_att_up = self.ssr_upsample(pred_att[..., None], spx_pred, pred_label)
        if self.att_weights_only:
            out["disp"] = (pred_att_up * 4, pred_att * 4) if train else (pred_att_up * 4,)
            return out

        # stage 2: top-k sampled concat volume at /4 (this process's slab of
        # the k planes under a mesh)
        samples_k, att_k = samples, att_topk
        if mesh is not None:
            pk, nk = mesh.slab(k)
            samples_k, att_k = samples[:, pk:pk + nk], att_topk[:, pk:pk + nk]
        if fuse:
            cc = self.concat_feature(torch.cat([fl[1], fr1]))
            lc, rc = cc[:b], cc[b:]
        else:
            lc = self._call("concat", self.concat_feature, fl[1])
            rc = self._call("concat", self.concat_feature, fr1)
        warped_rc, tiled_lc = warp_with_left(lc, rc, samples_k)
        # att * concat(tiled left, warped right): [B, K, H4, W4, 64]; eval
        # writes it in place, which autograd cannot follow
        if train:
            volume = att_k[..., None] * torch.cat([tiled_lc, warped_rc], dim=-1)
        else:
            c = lc.shape[-1]
            volume = torch.empty((*warped_rc.shape[:-1], 2 * c), dtype=lc.dtype,
                                 device=lc.device)
            torch.mul(att_k[..., None], tiled_lc, out=volume[..., :c])
            torch.mul(att_k[..., None], warped_rc, out=volume[..., c:])
        volume = self.concat_stem(volume, mesh=mesh)
        volume = self.concat_feature_att_4(volume, fl[1])
        cost = self._call("hourglass", self.hourglass, volume, mesh=mesh)
        cost = self.classif(cost, mesh=mesh)[..., 0]
        if mesh is not None:
            cost = gather_planes(cost, mesh)
        pred = regression_topk(cost, samples, self.refine_topk)
        pred_up = self.ssr_upsample(pred[..., None], spx_pred, pred_label)
        if train:
            out["disp"] = (pred_up * 4, pred * 4, pred_att_up * 4, pred_att * 4)
        else:
            out["disp"] = (pred_up * 4,)
        return out
