"""Load the JAX package's variable trees into the port.

``load_flax_variables(model, params, batch_stats)`` takes the flax
``params`` and ``batch_stats`` trees of ``semstereo_tpu.models.SemStereo``
(nested dicts of numpy arrays) and fills every parameter and BN buffer of
the port.  It is the inverse of the JAX package's torch-to-flax converter
(``utils/torch_convert.py`` with ``utils/timm_convert.py`` for the
backbone): the port uses the reference torch state-dict names, so each
entry below pairs one of them with its flax leaf and layout.

Flax layouts (torch on the right):
  conv2d   [kh, kw, I, O]      <- [O, I, kh, kw]
  conv3d   [kd, kh, kw, I, O]  <- [O, I, kd, kh, kw]
  deconv2d [kh, kw, I, O]      <- [I, O, kh, kw]
  deconv3d [kd, kh, kw, I, O]  <- [I, O, kd, kh, kw]
  dense    [I, O]              <- [O, I] (Linear) or [O, I, 1(, 1, 1)] (1x1 conv)
"""

from __future__ import annotations

import numpy as np
import torch


def _c2(a):
    return np.transpose(a, (3, 2, 0, 1))


def _c3(a):
    return np.transpose(a, (4, 3, 0, 1, 2))


def _d2(a):
    return np.transpose(a, (2, 3, 0, 1))


def _d3(a):
    return np.transpose(a, (3, 4, 0, 1, 2))


def _dense(a):
    return np.transpose(a)


def _dense2(a):
    return np.transpose(a)[:, :, None, None]


def _dense3(a):
    return np.transpose(a)[:, :, None, None, None]


def _same(a):
    return a


class _Plan:
    """(torch key, flax tree, flax path, layout fn) entries."""

    def __init__(self):
        self.entries: list[tuple[str, str, str, object]] = []

    def p(self, key, path, fn=_same):
        self.entries.append((key, "params", path, fn))

    def bn(self, src, dst):
        self.p(f"{src}.weight", f"{dst}/scale")
        self.p(f"{src}.bias", f"{dst}/bias")
        self.entries.append((f"{src}.running_mean", "batch_stats", f"{dst}/mean", _same))
        self.entries.append((f"{src}.running_var", "batch_stats", f"{dst}/var", _same))

    def conv(self, src, dst, fn=_c2, bias=False):
        self.p(f"{src}.weight", f"{dst}/kernel", fn)
        if bias:
            self.p(f"{src}.bias", f"{dst}/bias")

    def basic(self, src, dst, fn=_c2):
        self.conv(f"{src}.conv", f"{dst}/conv", fn)
        self.bn(f"{src}.bn", f"{dst}/bn")

    def convbn_seq(self, src, dst, fn=_c3):
        self.conv(f"{src}.0", f"{dst}/conv", fn)
        self.bn(f"{src}.1", f"{dst}/bn")

    def conv2x(self, src, dst):
        self.basic(f"{src}.conv1", f"{dst}/conv1", _d2)
        self.basic(f"{src}.conv2", f"{dst}/conv2")

    def hourglass(self, src, dst):
        for i in (1, 2, 3, 4):
            self.convbn_seq(f"{src}.conv{i}.0", f"{dst}/conv{i}")
        for i in (5, 6):
            self.conv(f"{src}.conv{i}.0", f"{dst}/conv{i}/conv", _d3)
            self.bn(f"{src}.conv{i}.1", f"{dst}/conv{i}/bn")
        self.convbn_seq(f"{src}.redir1", f"{dst}/redir1")
        self.convbn_seq(f"{src}.redir2", f"{dst}/redir2")
        att = f"{src}.attention_block"
        self.p(f"{att}.qkv_3d.weight", f"{dst}/attention/qkv/kernel", _dense)
        self.p(f"{att}.qkv_3d.bias", f"{dst}/attention/qkv/bias")
        self.p(f"{att}.final1x1.weight", f"{dst}/attention/final1x1/kernel", _dense3)
        self.p(f"{att}.final1x1.bias", f"{dst}/attention/final1x1/bias")

    def classifier(self, src, dst):
        self.convbn_seq(f"{src}.0", f"{dst}/conv0")
        self.conv(f"{src}.2", f"{dst}/conv1", _c3)

    def channel_att(self, src, dst):
        self.basic(f"{src}.im_att.0", f"{dst}/im_att0")
        self.conv(f"{src}.im_att.1", f"{dst}/im_att1", bias=True)

    def seghead(self, src, dst):
        self.basic(f"{src}.conv1", f"{dst}/conv1")
        self.conv(f"{src}.conv2", f"{dst}/conv2", bias=True)

    def ssr(self, src, dst):
        self.bn(f"{src}.conv.0", f"{dst}/conv_bn0")
        self.conv(f"{src}.conv.1", f"{dst}/conv", bias=True)
        self.bn(f"{src}.conv.2", f"{dst}/conv_bn1")
        self.conv(f"{src}.conv1.0", f"{dst}/conv1", bias=True)
        self.bn(f"{src}.conv1.1", f"{dst}/conv1_bn")
        self.conv(f"{src}.conv2.0", f"{dst}/conv2", bias=True)
        self.bn(f"{src}.conv2.1", f"{dst}/conv2_bn")
        self.conv(f"{src}.conv3", f"{dst}/conv3", bias=True)

    def cna(self, src, dst):
        self.conv(f"{src}.conv", f"{dst}/conv")
        self.bn(f"{src}.bn", f"{dst}/bn")

    def backbone(self, src, dst):
        self.cna(f"{src}.conv_stem", f"{dst}/stem")
        for name, blk in (("stage0_0", "block0.0"), ("stage1_0", "block1.0"),
                          ("stage1_1", "block1.1"), ("stage2_0", "block2.0"),
                          ("stage3_0", "block3.0"), ("stage4_0", "block4.0")):
            for tdst, tsrc in (("expand", "conv1_1x1"), ("dw", "conv2_kxk"),
                               ("project", "conv3_1x1")):
                self.cna(f"{src}.{blk}.{tsrc}", f"{dst}/{name}/{tdst}")
        for name, blk, depth in (("stage2_1", "block2.1", 2), ("stage3_1", "block3.1", 4),
                                 ("stage4_1", "block4.1", 3)):
            s, d = f"{src}.{blk}", f"{dst}/{name}"
            self.cna(f"{s}.conv_kxk", f"{d}/local_dw")
            self.p(f"{s}.conv_1x1.weight", f"{d}/local_proj/kernel", _c2)
            for i in range(depth):
                t, b = f"{s}.transformer.{i}", f"{d}/block{i}"
                for n in ("norm1", "norm2"):
                    self.p(f"{t}.{n}.weight", f"{b}/{n}/scale")
                    self.p(f"{t}.{n}.bias", f"{b}/{n}/bias")
                for tsrc, tdst in (("attn.qkv_proj", "attn/qkv"), ("attn.out_proj", "attn/proj"),
                                   ("mlp.fc1", "ffn1"), ("mlp.fc2", "ffn2")):
                    self.p(f"{t}.{tsrc}.weight", f"{b}/{tdst}/kernel", _dense2)
                    self.p(f"{t}.{tsrc}.bias", f"{b}/{tdst}/bias")
            self.p(f"{s}.norm.weight", f"{d}/norm/scale")
            self.p(f"{s}.norm.bias", f"{d}/norm/bias")
            self.cna(f"{s}.conv_proj", f"{d}/proj_out")


def plan_for(model) -> list[tuple[str, str, str, object]]:
    """Every (torch key, flax tree, flax path, layout fn) of ``model``."""
    pl = _Plan()
    pl.backbone("feature", "feature")
    for lvl in ("32_16", "16_8", "8_4", "4_2"):
        pl.conv2x(f"feature_up.deconv{lvl}", f"feature_up/deconv{lvl}")
    if model.seg_if:
        pl.seghead("head_l", "head_l")
        pl.seghead("head_r", "head_r")
    if model.stereo_if:
        pl.p("gamma", "gamma")
        pl.p("beta", "beta")
        for i in range(5):
            pl.conv(f"chal_{i}.0", f"chal_{i}/conv", bias=True)
            pl.bn(f"chal_{i}.1", f"chal_{i}/bn")
        for lvl in ("32_16", "16_8", "8_4", "4_2"):
            pl.conv2x(f"spx{lvl}", f"spx{lvl}")
        pl.conv("spx2.0", "spx2", _d2, bias=True)
        pl.p("patch.weight", "patch/kernel", _c3)
        pl.channel_att("corr_feature_att_8", "corr_feature_att_8")
        pl.hourglass("hourglass_att", "hourglass_att")
        pl.classifier("classif_att_", "classif_att")
        pl.ssr("ssr_upsample", "ssr_upsample")
        if not model.att_weights_only:
            pl.basic("concat_feature.0", "concat_feature/cf0")
            pl.conv("concat_feature.1", "concat_feature/cf1")
            pl.basic("concat_stem", "concat_stem", _c3)
            pl.channel_att("concat_feature_att_4", "concat_feature_att_4")
            pl.hourglass("hourglass", "hourglass")
            pl.classifier("classif", "classif")
    return pl.entries


def _leaf(tree, path):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node)


def _count_leaves(tree) -> int:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return sum(_count_leaves(v) for _, v in tree.items())
    return 1


@torch.no_grad()
def load_flax_variables(model, params, batch_stats) -> int:
    """Fill ``model``'s parameters and BN buffers from flax trees; returns the
    number of leaves loaded.  Raises if a tensor of the port is left unfilled,
    a flax leaf is left unused, or a shape disagrees."""
    trees = {"params": params, "batch_stats": batch_stats}
    state = model.state_dict()
    entries = plan_for(model)
    missing = sorted(set(state) - {k for k, *_ in entries})
    if missing:
        raise KeyError(f"no flax source for {len(missing)} port tensors: {missing[:8]}")
    n_flax = _count_leaves(params) + _count_leaves(batch_stats)
    if n_flax != len(entries):
        raise ValueError(f"{n_flax} flax leaves for {len(entries)} port tensors")
    for key, tree, path, fn in entries:
        val = np.ascontiguousarray(fn(_leaf(trees[tree], path)))
        dst = state[key]
        if tuple(val.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: flax {path} gives {val.shape}, port has {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(val.astype(np.float32)).to(dst.dtype))
    return len(entries)
