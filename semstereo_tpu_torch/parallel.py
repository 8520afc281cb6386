"""Data and disparity parallelism over processes (counterpart of
``semstereo_tpu/parallel/mesh.py``'s ``data`` and ``disp`` axes).

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

Disparity parallelism (``make_mesh``, the mesh's ``disp`` axis): the
processes are laid out as ``make_mesh`` lays out devices, ``(data, disp)``
in row-major order, so rank = data_index * disp + disp_index and ``disp``
consecutive ranks form one disp group.  The processes of a group hold the
same rows and compute everything outside the two cost-volume pipelines
whole; each holds one slab of the volumes' planes, from the cost volume to
the classifier's output.  ``halo_pad`` gives a 3-D conv the planes next to
its slab, ``gather_planes`` puts the slabs back together, and
``broadcast_from_group`` makes the group agree on the top-k planes; each
differentiable one has its adjoint as backward.  The world-wide reductions
above stay right: a group's processes each compute the same share of the
loss, scaled by 1/disp through the world-summed denominators, and the
gradient all-reduce sums the shares (and the slabs' parts) back.  Only
all-reduce, all-gather and broadcast are used, the collectives gloo takes
for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from semstereo_tpu_torch.config import ModelConfig, ParallelConfig


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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process layout ``(data, disp)``: this process's place in it and
    its disp group (``None`` when ``disp`` is 1)."""

    data: int
    disp: int
    data_index: int = 0
    disp_index: int = 0
    disp_group: object = None

    @property
    def split(self) -> bool:
        """Whether the cost volumes are split into plane slabs."""
        return self.disp > 1

    def slab(self, planes: int) -> tuple[int, int]:
        """(first plane, plane count) of this process's slab of a volume of
        ``planes`` planes."""
        n = planes // self.disp
        return self.disp_index * n, n


def _data_count(data: int, disp: int, world: int) -> int:
    """The data axis that ``data`` (-1: the rest) gives beside ``disp`` in
    ``world`` processes; raises unless data x disp is the world."""
    if disp < 1:
        raise ValueError(f"disp={disp}: the disp axis takes at least one process")
    if data == -1:
        if world % disp:
            raise ValueError(f"disp={disp} does not divide the {world} processes started")
        data = world // disp
    if data * disp != world:
        raise ValueError(f"data={data} x disp={disp} processes, but {world} were started "
                         f"(launch one process per (data, disp) pair, e.g. torchrun "
                         f"--nproc-per-node {data * disp})")
    return data


def make_mesh(data: int = -1, disp: int = 1) -> Mesh:
    """The mesh of this process group (``mesh.py::make_mesh``'s rule: data
    -1 takes the processes that ``disp`` leaves).  Every process must call
    it, in the same order as its other groups: it makes one
    ``dist.new_group`` per disp group.  Installs no global context."""
    world, rank = process_count(), process_index()
    data = _data_count(data, disp, world)
    group = None
    if disp > 1:
        for d in range(data):
            g = dist.new_group(list(range(d * disp, (d + 1) * disp)))
            if d == rank // disp:
                group = g
    return Mesh(data=data, disp=disp, data_index=rank // disp, disp_index=rank % disp,
                disp_group=group)


def volume_planes(maxdisp: int, symmetric: bool, topk: int, att_weights_only: bool) -> dict:
    """The plane counts of the model's two cost volumes: the /8 cosine
    volume and, in stage 2, the /4 top-k concat volume."""
    d8 = maxdisp // 8 * (2 if symmetric else 1)
    planes = {"/8 cosine": d8}
    if not att_weights_only:
        planes["/4 top-k concat"] = min(topk, 2 * d8)
    return planes


def check_disp_planes(planes: dict, disp: int) -> None:
    """Raises ``ValueError`` unless each cost volume of ``planes``
    (``volume_planes``) splits into ``disp`` slabs of a multiple of 4
    planes (the hourglass halves a slab twice and must stay on the global
    grid).  The JAX package pads uneven shards; the port refuses them."""
    for name, planes in planes.items():
        if planes % (4 * disp):
            raise ValueError(f"disp={disp}: the {name} volume's {planes} planes do not split "
                             f"into {disp} slabs of a multiple of 4 planes")


def check_parallel(cfg: ParallelConfig, world: int, model: ModelConfig | None = None) -> None:
    """Raises ``ValueError`` unless ``cfg`` describes ``data`` x ``disp``
    processes filling ``world`` (``data`` -1: the rest) and, given the
    model, each of its cost volumes splits into ``disp`` slabs."""
    if cfg.space != 1:
        raise ValueError(f"space={cfg.space}: spatial parallelism is not ported yet; it is "
                         "the next module of ROADMAP.md, section 1")
    if not cfg.sync_bn:
        raise ValueError("sync_bn=False (per-process BatchNorm statistics) is not ported; "
                         "the data-parallel step takes global statistics, as the JAX "
                         "package does under GSPMD")
    _data_count(cfg.data, cfg.disp, world)
    if model is not None:
        check_disp_planes(volume_planes(model.maxdisp, model.symmetric, model.topk,
                                        model.att_weights_only), cfg.disp)


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


class _GatherPlanes(torch.autograd.Function):
    """All-gather of the slabs along axis 1; backward: the adjoint, the
    cotangent summed over the group, then this process's slab of it."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(x) for _ in range(mesh.disp)]
        dist.all_gather(parts, x.contiguous(), group=mesh.disp_group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.disp_group)
        p0, n = mesh.slab(g.shape[1])
        return g[:, p0:p0 + n], None


def gather_planes(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole volume [B, D, ...] from each process's slab [B, D/disp,
    ...] of it, differentiably."""
    return _GatherPlanes.apply(x, mesh)


class _HaloPad(torch.autograd.Function):
    """[plane below, x, plane above] along axis 1 (each side if asked): the
    neighbouring slabs' edge planes, zeros at the volume's ends.  Backward:
    each halo's cotangent goes back to its owner and is added to its edge
    plane there."""

    @staticmethod
    def forward(ctx, x, mesh, below, above):
        ctx.mesh, ctx.below, ctx.above = mesh, below, above
        # my last plane is the upper neighbour's "below", my first the lower's "above"
        send = [x[:, -1]] * below + [x[:, 0]] * above
        parts = _all_gather_stacked(send, mesh)
        i, last = mesh.disp_index, mesh.disp - 1
        out = [x]
        if below:
            out.insert(0, parts[i - 1][0] if i > 0 else torch.zeros_like(x[:, 0]))
        if above:
            out.append(parts[i + 1][below] if i < last else torch.zeros_like(x[:, 0]))
        return torch.cat([t if t.dim() == x.dim() else t[:, None] for t in out], dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh, below, above = ctx.mesh, ctx.below, ctx.above
        n = g.shape[1] - below - above
        gx = g[:, below:below + n].clone()
        send = [g[:, 0]] * below + [g[:, -1]] * above
        parts = _all_gather_stacked(send, mesh)
        i, last = mesh.disp_index, mesh.disp - 1
        if below and i < last:  # the upper neighbour's lower halo is my last plane
            gx[:, -1] += parts[i + 1][0]
        if above and i > 0:  # the lower neighbour's upper halo is my first plane
            gx[:, 0] += parts[i - 1][below]
        return gx, None, None, None


def _all_gather_stacked(planes: list, mesh: Mesh) -> list:
    """Each process's ``planes`` (equal shapes), stacked, gathered over the
    disp group: one [len(planes), ...] tensor per process."""
    send = torch.stack([p.contiguous() for p in planes])
    parts = [torch.empty_like(send) for _ in range(mesh.disp)]
    dist.all_gather(parts, send, group=mesh.disp_group)
    return parts


def halo_pad(x: torch.Tensor, mesh: Mesh, below: bool, above: bool) -> torch.Tensor:
    """This process's slab x [B, n, ...] with the plane below it and/or
    the one above it along axis 1, from the neighbouring slabs (zeros past
    the volume's ends), differentiably."""
    return _HaloPad.apply(x, mesh, int(below), int(above))


def broadcast_from_group(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` (no gradient) as the disp group's first process holds it."""
    t = t.contiguous().clone()
    dist.broadcast(t, src=mesh.data_index * mesh.disp, group=mesh.disp_group)
    return t


def _collective_device() -> torch.device:
    """Where the group's collectives take tensors: the card for NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
