"""Windowed 3-D multi-head self-attention over cost volumes (counterpart of
``semstereo_tpu/nn/attention.py``).

The (D, H, W) volume is cut into (bd, bh, bw) windows with token order
(bd, bh, bw); D, H and W are padded to window multiples, and an additive
-1000 bias keeps padded and real cells from attending to each other.
Windows are small (64 or 96 tokens, C=128), so two batched matmuls suffice.

Given a ``mesh`` that splits the volume, x is this process's slab of the
bottleneck's planes.  A window spans the whole bottleneck's depth (4 of 4
planes at /8, 6 of 6 at /4), so no slab holds one: the planes are gathered
over the disp group (``parallel.gather_planes``, whose backward sums the
cotangent over the group), every process attends over the whole volume and
keeps its slab.

On row slabs (``layers.split_rows``) the windows stay local: a slab of the
bottleneck holds a whole number of windows along H
(``parallel.check_space_rows`` refuses any other split), so each process
attends within its own windows and no window spans two slabs.  The port
does not gather the bottleneck along H.  Under both splits, x is this
process's slab of planes of its row slab: the planes are gathered over the
disp group, whose processes hold the same rows, and the windows along H
stay local to the row slab.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semstereo_tpu_torch.nn.layers import rows_of
from semstereo_tpu_torch.parallel import gather_planes

NUM_HEADS = 16


class WindowedAttention3D(nn.Module):
    """Children ``qkv_3d`` (Linear C -> 3C) and ``final1x1`` (1x1x1 Conv3d),
    as in the reference ``attention_block``; 16 heads."""

    def __init__(self, channels: int, window):
        super().__init__()
        self.window = tuple(window)
        self.qkv_3d = nn.Linear(channels, 3 * channels)
        self.final1x1 = nn.Conv3d(channels, channels, 1)

    def forward(self, x, mesh=None):
        keep = None
        if mesh is not None and mesh.split:
            p0, n = mesh.slab(x.shape[1] * mesh.disp)
            keep = slice(p0, p0 + n)
            x = gather_planes(x, mesh)
        # one memory layout (the gather's) for both paths: the matmuls below
        # round by their operands' strides in bf16
        x = x.contiguous()
        b, d0, h0, w0, c = x.shape
        bd, bh, bw = self.window
        pad_d, pad_b, pad_r = (-d0) % bd, (-h0) % bh, (-w0) % bw
        if pad_b and rows_of(self) is not None:
            raise ValueError(f"a slab of {h0} bottleneck rows does not hold whole attention "
                             f"windows of {bh} rows (parallel.check_space_rows)")
        d, h, w = d0 + pad_d, h0 + pad_b, w0 + pad_r
        any_pad = bool(pad_d or pad_b or pad_r)
        if any_pad:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d))
        nd, nh, nw = d // bd, h // bh, w // bw
        t = bd * bh * bw
        xw = x.reshape(b, nd, bd, nh, bh, nw, bw, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        xw = xw.reshape(b, nd * nh * nw, t, c)

        heads, hd = NUM_HEADS, c // NUM_HEADS
        qkv = self.qkv_3d(xw).reshape(b, nd * nh * nw, t, 3, heads, hd)
        q, k, v = (qkv[..., i, :, :].transpose(2, 3) for i in range(3))  # [B, N, h, T, hd]
        attn = torch.matmul(q, k.transpose(-1, -2)) * hd**-0.5  # [B, N, h, T, T]
        if any_pad:
            padded = torch.zeros((d, h, w), dtype=torch.bool, device=x.device)
            padded[d0:] = True
            padded[:, h0:] = True
            padded[:, :, w0:] = True
            pw = padded.reshape(nd, bd, nh, bh, nw, bw).permute(0, 2, 4, 1, 3, 5)
            pw = pw.reshape(nd * nh * nw, t)
            bias = (pw[:, None, :] != pw[:, :, None]).to(attn.dtype) * -1000.0
            attn = attn + bias[None, :, None]
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(2, 3).reshape(b, nd, nh, nw, bd, bh, bw, c)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)
        if any_pad:
            out = out[:, :d0, :h0, :w0]
        out = F.linear(out, self.final1x1.weight[:, :, 0, 0, 0], self.final1x1.bias)
        # the slab after the projection: the matmul then has one process's
        # shape, and so its rounding (a slab's rows round otherwise in bf16)
        return out if keep is None else out[:, keep]
