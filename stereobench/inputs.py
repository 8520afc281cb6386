"""The traffic's inputs, made on the device from ``--seed``.

One general generator reads a traffic file's parameters: every pair is a
random right view and the left view its roll along W by one integer
disparity drawn from ``shift_range`` (as ``chip_smoke.stereo_pair`` and
``SyntheticStereoDataset`` make them); a train row also holds its ground
truth, that disparity everywhere (and at /4), and one constant label below
the ignore class.  Every seed gives the same sizes; only the values and
the shifts differ.
"""

from __future__ import annotations

import torch

from stereobench.weights import generator


def pairs(traffic: dict, num_classes: int, seed: int, device, dtype=torch.float32):
    """``traffic['pool']`` batches of ``traffic['batch']`` rows: dicts with
    left, right [B, H, W, 3] in ``dtype``, and disparity, disparity_4 and
    label (fp32)."""
    n = traffic["pool"] * traffic["batch"]
    h, w = traffic["height"], traffic["width"]
    gen = generator(seed, 1, device)
    right = torch.randn((n, h, w, 3), generator=gen, device=device)
    lo, hi = traffic["shift_range"]
    shifts = torch.randint(lo, hi, (n,), generator=gen, device=device).tolist()
    labels = torch.randint(0, num_classes - 1, (n,), generator=gen, device=device).float()
    left = torch.stack([torch.roll(r, s, dims=1) for r, s in zip(right, shifts)])
    disp = torch.tensor(shifts, dtype=torch.float32, device=device)[:, None, None].expand(n, h, w)
    rows = dict(left=left.to(dtype), right=right.to(dtype), disparity=disp.contiguous(),
                disparity_4=disp[:, ::4, ::4].contiguous(),
                label=labels[:, None, None].expand(n, h, w).contiguous())
    b = traffic["batch"]
    return [{k: v[i * b:(i + 1) * b] for k, v in rows.items()} for i in range(traffic["pool"])]
