"""Checkpoints: save and restore {epoch, model state_dict, optimizer
state_dict}, with latest-epoch resume and the filtered partial restore of
stage 1 into stage 2 (counterpart of ``semstereo_tpu/train/checkpoint.py``).

One file per epoch, ``<logdir>/checkpoint_<epoch:06d>.pt``, written by
``torch.save`` to a temporary name and moved into place, so a partly
written file never counts as a checkpoint.  It holds ``epoch``, ``model``
(the fp32 master weights and the BN running statistics) and ``optimizer``
(Adam's moments and step counts), every tensor on the CPU, so a checkpoint
written on the card loads on the CPU.  Loading uses ``weights_only=True``:
the file holds tensors, numbers, strings and containers, no pickled object.
Under data parallelism every process holds the same state: process 0 writes
the file, and every process loads it to its own device.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from semstereo_tpu_torch.parallel import process_index
from semstereo_tpu_torch.train.state import TrainState, merge_partial_params

_FILE = re.compile(r"^checkpoint_(\d{6})\.pt$")


def checkpoint_path(logdir: str, epoch: int) -> str:
    return os.path.join(logdir, f"checkpoint_{epoch:06d}.pt")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(logdir: str, state: TrainState, epoch: int) -> str:
    """Writes the checkpoint of ``epoch`` (process 0 only); returns its
    path."""
    path = checkpoint_path(logdir, epoch)
    if process_index() != 0:
        return path
    os.makedirs(logdir, exist_ok=True)
    payload = {"epoch": int(epoch), "model": _to_cpu(state.model.state_dict()),
               "optimizer": _to_cpu(state.optimizer.state_dict())}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(logdir: str) -> Optional[int]:
    """The highest epoch with a complete checkpoint in ``logdir``, or None."""
    if not os.path.isdir(logdir):
        return None
    epochs = [int(m.group(1)) for m in map(_FILE.match, os.listdir(logdir)) if m]
    return max(epochs) if epochs else None


def _load(logdir: str, epoch: Optional[int]) -> dict:
    epoch = latest_epoch(logdir) if epoch is None else epoch
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints in {logdir}")
    return torch.load(checkpoint_path(logdir, epoch), map_location="cpu", weights_only=True)


def restore_checkpoint(logdir: str, state: TrainState,
                       epoch: Optional[int] = None) -> TrainState:
    """Full restore (the --resume path): every weight, BN statistic and
    optimizer moment, and ``state.epoch`` = the saved epoch + 1.  The
    moments go to the parameters' device; Adam keeps its step counts on the
    CPU, where ``load_state_dict`` leaves them."""
    payload = _load(logdir, epoch)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.epoch = payload["epoch"] + 1
    return state


def restore_partial(logdir: str, state: TrainState,
                    epoch: Optional[int] = None) -> tuple[TrainState, int]:
    """Filtered partial load of the model: every state_dict entry whose key
    and shape match (a stage-1 attention-only checkpoint into the full
    stage-2 model).  The optimizer and epoch stay as they are.  Returns
    (state, number of tensors loaded): parameters plus BN running
    statistics, which is what the JAX package counts (params + batch_stats
    leaves), since the port's BatchNorm keeps no other buffer."""
    payload = _load(logdir, epoch)
    merged, n = merge_partial_params(state.model.state_dict(), payload["model"])
    state.model.load_state_dict(merged)
    return state, n
