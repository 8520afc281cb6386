"""Load a timm ``mobilevitv2_100`` checkpoint into the port's backbone
(counterpart of ``semstereo_tpu/utils/timm_convert.py``).

The reference backbone is timm's pretrained ``mobilevitv2_100`` in
features-only mode.  A state_dict of it, saved with ``torch.save``
(``timm.create_model('mobilevitv2_100', pretrained=True).state_dict()``),
has the keys ``stem.conv.weight``, ``stem.bn.*`` and
``stages.N.blocks.M.<name>``; the port's backbone (``nn/backbone.py``)
keeps timm's names under ``conv_stem`` and ``blockN.M``, in timm's layouts,
so the mapping is a renaming.  It maps what the JAX converter maps: every
parameter and BatchNorm running statistic of the stem, the bottleneck
blocks and the MobileViTv2 blocks (timm's ``num_batches_tracked`` counters
have no counterpart).
"""

from __future__ import annotations

import re

import torch

_STAGE = re.compile(r"^stages\.(\d+)\.blocks\.(\d+)\.(.+)$")


def convert_state_dict(sd: dict) -> dict:
    """timm key -> the port's backbone key (relative to ``SemStereo.feature``)
    for every entry of ``sd`` that has one; the values are kept as they are."""
    out = {}
    for key, value in sd.items():
        if key.startswith("stem."):
            out["conv_stem." + key[len("stem."):]] = value
            continue
        m = _STAGE.match(key)
        if m:
            out[f"block{m.group(1)}.{m.group(2)}.{m.group(3)}"] = value
    return out


def load_and_merge(ckpt_path: str, model, require_complete: bool = True) -> int:
    """Loads the timm state_dict at ``ckpt_path`` into ``model.feature`` (the
    backbone of a ``SemStereo``): each backbone parameter and running
    statistic whose converted key is present with the same shape takes the
    checkpoint's value (cast to the model's dtype, on its device).  Returns
    the number of tensors loaded, which is the JAX converter's count of
    leaves (params + batch_stats).

    ``require_complete`` (the default) raises ``ValueError``, before
    anything is loaded, if any backbone tensor would keep its fresh value: a
    naming or shape mismatch against a real checkpoint must fail loudly, not
    train from scratch without a word.  Pass False only for a checkpoint
    that is partial on purpose."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    converted = convert_state_dict(sd)
    backbone = model.feature
    current = backbone.state_dict()
    take = {k: converted[k] for k, v in current.items()
            if k in converted and tuple(converted[k].shape) == tuple(v.shape)}
    if require_complete and len(take) < len(current):
        missing = [f"feature.{k}" for k in current if k not in take]
        head = "\n  ".join(missing[:12])
        more = f"\n  ... and {len(missing) - 12} more" if len(missing) > 12 else ""
        raise ValueError(
            f"timm conversion of {ckpt_path!r} left {len(missing)} backbone tensors at "
            f"their fresh values (a naming or shape mismatch against the mobilevitv2_100 "
            f"layout):\n  {head}{more}\nPass require_complete=False to accept a partial load.")
    with torch.no_grad():
        for k, v in take.items():
            current[k].copy_(v)
    return len(take)
