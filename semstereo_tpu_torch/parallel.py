"""Data parallelism over processes (counterpart of
``semstereo_tpu/parallel/mesh.py``'s ``data`` axis).

One process per device, started as ``torchrun`` starts it: the environment
gives ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``.  ``init_process_group`` joins that group (NCCL for the
card, gloo for the CPU) and returns the rank's device.

The JAX package runs the train step on one global array sharded over the
mesh's ``data`` axis, so every mean in it is a mean over the global batch.
The port keeps that result with one process per shard: each masked mean
takes its numerator over the process's rows and its denominator summed
over the processes (``global_sum``), so a process's loss is its share of
the global loss and the shares sum to it; BatchNorm normalises by
statistics all-reduced over the processes (``nn/layers.py``); the gradients
of the shares are summed in one flat all-reduce after the backward
(``all_reduce_grads``), and the step's scalars are summed the same way.  In
one process (no group, or a group of one) every function here is the
identity and issues no collective.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from semstereo_tpu_torch.config import ParallelConfig


def process_count() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_process_group(device="cuda", backend: str | None = None) -> torch.device:
    """Joins the process group that the ``torchrun`` environment describes
    and returns this rank's device (``cuda:LOCAL_RANK`` for the card, the
    CPU otherwise).  The backend is NCCL for the card and gloo for the CPU
    unless ``backend`` is given."""
    device = torch.device(device)
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            rank=rank, world_size=world)
    return device


def check_parallel(cfg: ParallelConfig, world: int) -> None:
    """Raises ``ValueError`` unless ``cfg`` describes data parallelism over
    ``world`` processes: ``data`` is -1 (the world size) or equal to it."""
    if cfg.disp != 1 or cfg.space != 1:
        raise ValueError(f"disp={cfg.disp}, space={cfg.space}: disparity and spatial "
                         "parallelism are not ported yet (ROADMAP.md, section 1)")
    if not cfg.sync_bn:
        raise ValueError("sync_bn=False (per-process BatchNorm statistics) is not ported; "
                         "the data-parallel step takes global statistics, as the JAX "
                         "package does under GSPMD")
    if cfg.data not in (-1, world):
        raise ValueError(f"data={cfg.data} data-parallel processes, but {world} were "
                         "started (launch one process per shard, e.g. torchrun "
                         f"--nproc-per-node {cfg.data})")


def global_sum(x):
    """``x`` (a number or a tensor without gradient) summed over the
    processes."""
    if process_count() == 1:
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().clone()
        dist.all_reduce(x)
        return x
    t = torch.tensor(float(x), dtype=torch.float64, device=_collective_device())
    dist.all_reduce(t)
    return t.item()


def all_reduce_scalars(scalars: dict) -> dict:
    """The 0-d tensors of ``scalars`` summed over the processes in one
    all-reduce (each process holds its share of a global mean); other
    entries unchanged."""
    if process_count() == 1:
        return scalars
    keys = [k for k, v in scalars.items() if isinstance(v, torch.Tensor) and v.dim() == 0]
    if not keys:
        return scalars
    flat = torch.stack([scalars[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    return dict(scalars, **dict(zip(keys, flat.unbind())))


def all_reduce_grads(params) -> None:
    """Sums the gradients of ``params`` over the processes in one flat
    all-reduce."""
    if process_count() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    torch._foreach_copy_(grads, torch._utils._unflatten_dense_tensors(flat, grads))


def all_reduce_sum_tree(tree):
    """Sums a tuple of numpy values (arrays or scalars) over the processes;
    the identity in one process.  The host-side reduction of the eval
    meters."""
    if process_count() == 1:
        return tree
    arrays = [np.asarray(x, np.float64) for x in tree]
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
    flat = flat.to(_collective_device())
    dist.all_reduce(flat)
    flat = flat.cpu().numpy()
    out, i = [], 0
    for a in arrays:
        out.append(flat[i:i + a.size].reshape(a.shape))
        i += a.size
    return tuple(out)


def broadcast_check(tensors, what: str) -> None:
    """Raises ``RuntimeError`` unless every process holds the same values in
    ``tensors`` as process 0 (checked by broadcasting rank 0's)."""
    if process_count() == 1:
        return
    local = torch._utils._flatten_dense_tensors([t.detach().float() for t in tensors])
    ref = local.clone()
    dist.broadcast(ref, src=0)
    if not torch.equal(ref, local):
        raise RuntimeError(f"process {process_index()} holds other {what} than process 0")


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def _collective_device() -> torch.device:
    """Where the group's collectives take tensors: the card for NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
