"""Data, disparity and spatial parallelism over processes (counterpart of
``semstereo_tpu/parallel/mesh.py``'s ``(data, disp, space)`` mesh).

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

The processes are laid out as ``make_mesh`` lays out devices, ``(data,
disp, space)`` in row-major order: rank = data_index * disp * space +
disp_index * space + space_index.  A disp group is the ``disp`` processes
of one (data, space) pair, ``space`` ranks apart; a space group the
``space`` consecutive processes of one (data, disp) pair.

Disparity parallelism (``make_mesh``'s ``disp`` axis): the processes of a
disp group hold the same rows and compute everything outside the two
cost-volume pipelines alike; each holds one slab of the volumes' planes,
from the cost volume to the classifier's output.  ``halo_pad`` gives a 3-D
conv the planes next to its slab, ``gather_planes`` puts the slabs back
together, and ``broadcast_from_group`` makes the group agree on the top-k
planes; each differentiable one has its adjoint as backward.  The
world-wide reductions above stay right: a group's processes each compute
the same share of the loss, scaled by 1/disp through the world-summed
denominators, and the gradient all-reduce sums the shares (and the slabs'
parts) back.  Only all-reduce, all-gather and broadcast are used, the
collectives gloo takes for CUDA tensors.

Spatial parallelism (``make_mesh``'s ``space`` axis): the processes of a
space group load the same rows (dealt by data index) and each keeps its
slab of rows [i * H / space, (i + 1) * H / space) of every key in
``SPATIAL_KEYS`` (``slab_rows``).
Nothing is replicated within a group: every process computes its rows of
every layer, from the input images to the disparity.  Each op whose output
row reads other rows takes its neighbours' edge rows (``halo_pad`` along
the height axis, zeros past the image for a zero-padded conv, copies of the
edge row for the edge-clamped resizes and propagation); each statistic that
spans the height (GroupNorm, the separable attention's softmax over
patches, the dice loss's sums) is all-reduced over the group (``space_sum``,
differentiable, and ``space_max``, which carries no gradient).  The
world-wide reductions stay right, as under disp: a masked mean's
denominator is summed over the world, so each process's share covers its
rows, and BatchNorm's statistics over the world are those of the whole
images.  ``check_space_rows`` holds the rules a slab must keep; the JAX
package pads an uneven shard, the port refuses it.

Both together (``disp`` and ``space`` above 1, the JAX package's
``_constrain_disp`` sharding a volume along its planes and its rows): each
process holds one slab of the volumes' planes of its slab of rows.  A
volume conv takes its halo along D over the disp group, then along H over
the space group of the D-haloed slab, so the corner blocks come with the
rows (``nn/layers.py``); the gathers of planes run within each row slab's
disp group, and the top-k choice is broadcast from that group's first
process.  Each world-wide sum above counts a pixel ``disp`` times, once
per process of its disp group, and stays right by the disp rule: each
process holds 1/disp of its rows' share.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

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


# Batch keys whose axis 1 is image height (a copy of ``mesh.py``'s set, kept
# explicit so that a key with another axis 1 is never split by rows).
SPATIAL_KEYS = frozenset({
    "left", "right", "disparity", "disparity_4", "disparity_8", "disparity_16", "label",
    "label_2", "label_4", "gx", "gy",
})


@dataclasses.dataclass(frozen=True)
class Part:
    """One axis of the mesh as this process sees it: the group of the
    processes along it (``None`` for an axis of 1), this process's index in
    it and its size."""

    group: object
    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process layout ``(data, disp, space)``: this process's place in
    it, its disp group and its space group (``None`` for an axis of 1)."""

    data: int
    disp: int
    data_index: int = 0
    disp_index: int = 0
    disp_group: object = None
    space: int = 1
    space_index: int = 0
    space_group: object = None

    @property
    def split(self) -> bool:
        """Whether the cost volumes are split into plane slabs."""
        return self.disp > 1

    @property
    def rows(self) -> bool:
        """Whether the images and volumes are split into row slabs."""
        return self.space > 1

    @property
    def disp_part(self) -> Part:
        return Part(self.disp_group, self.disp_index, self.disp)

    @property
    def space_part(self) -> Part:
        return Part(self.space_group, self.space_index, self.space)

    def slab(self, planes: int) -> tuple[int, int]:
        """(first plane, plane count) of this process's slab of a volume of
        ``planes`` planes."""
        n = planes // self.disp
        return self.disp_index * n, n

    def row_slab(self, rows: int) -> tuple[int, int]:
        """(first row, row count) of this process's slab of ``rows`` rows."""
        if rows % self.space:
            raise ValueError(f"{rows} rows do not split into {self.space} slabs")
        n = rows // self.space
        return self.space_index * n, n


def _data_count(data: int, disp: int, world: int, space: int = 1) -> int:
    """The data axis that ``data`` (-1: the rest) gives beside ``disp`` and
    ``space`` in ``world`` processes; raises unless data x disp x space is
    the world."""
    if disp < 1 or space < 1:
        raise ValueError(f"disp={disp}, space={space}: each axis takes at least one process")
    model = disp * space
    axes = " x ".join(f"{k}={v}" for k, v in (("disp", disp), ("space", space))
                      if v > 1 or (k == "disp" and space == 1))
    if data == -1:
        if world % model:
            raise ValueError(f"{axes} does not divide the {world} processes started")
        data = world // model
    if data * model != world:
        raise ValueError(f"data={data} x {axes} processes, but {world} were started (launch "
                         f"one process per place on the mesh, e.g. torchrun --nproc-per-node "
                         f"{data * model})")
    return data


def make_mesh(data: int = -1, disp: int = 1, space: int = 1) -> Mesh:
    """The mesh of this process group (``mesh.py::make_mesh``'s rule: data
    -1 takes the processes that ``disp`` and ``space`` leave).  Every
    process must call it, in the same order as its other groups: it makes
    one ``dist.new_group`` per disp group and per space group.  Installs no
    global context."""
    world, rank = process_count(), process_index()
    data = _data_count(data, disp, world, space)
    d, p, s = rank // (disp * space), rank // space % disp, rank % space
    disp_group = space_group = None
    for dd in range(data):
        base = dd * disp * space
        if disp > 1:
            for ss in range(space):
                g = dist.new_group([base + pp * space + ss for pp in range(disp)])
                if (dd, ss) == (d, s):
                    disp_group = g
        if space > 1:
            for pp in range(disp):
                g = dist.new_group([base + pp * space + ss for ss in range(space)])
                if (dd, pp) == (d, p):
                    space_group = g
    return Mesh(data=data, disp=disp, data_index=d, disp_index=p, disp_group=disp_group,
                space=space, space_index=s, space_group=space_group)


def slab_rows(batch: dict, mesh: Mesh | None) -> dict:
    """This process's slab of rows of each key of ``batch`` in
    ``SPATIAL_KEYS`` (arrays of rank 3 or more), the other entries as they
    are (``mesh.py::shard_batch(spatial=True)``, which asserts that the
    height divides over ``space``)."""
    if mesh is None or not mesh.rows:
        return batch
    out = dict(batch)
    for k, v in batch.items():
        if k in SPATIAL_KEYS and getattr(v, "ndim", 0) >= 3:
            if v.shape[1] % mesh.space:
                raise ValueError(f"batch['{k}'] height {v.shape[1]} does not split into "
                                 f"{mesh.space} slabs")
            r0, n = mesh.row_slab(v.shape[1])
            out[k] = v[:, r0:r0 + n]
    return out


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


# The model's stride-2 levels (a conv or patch grid halves each of them)
# and the levels of the MobileViTv2 blocks' 2x2 patches.
_STRIDE2_LEVELS = (1, 2, 4, 8, 16)
_PATCH_LEVELS = (8, 16, 32)


def check_space_rows(height: int, space: int, model: ModelConfig | None = None) -> None:
    """Raises ``ValueError``, naming the level and its rows, unless ``space``
    slabs of an image of ``height`` rows keep every height-coupled op on the
    global grid: the slab's rows are even at the input of each stride-2
    conv (the image, /2, /4, /8 and /16; the volumes' hourglasses halve /8
    and /4 twice, within the same levels), and at /8, /16 and /32, where
    the MobileViTv2 blocks cut 2x2 patches (so a slab holds an even number
    of /32 rows: 64 image rows a slab at the least).  Given the model, the
    attention windows along H must tile the slab at the two hourglass
    bottlenecks, /32 for ``hourglass_att`` and, in stage 2, /16 for
    ``hourglass``: the port attends within each slab's windows and does not
    gather the bottlenecks.  The JAX package pads uneven shards; the port
    refuses them."""
    if space < 1 or height % space:
        raise ValueError(f"space={space}: the image's {height} rows do not split into "
                         f"{space} slabs")
    n = height // space

    def rows_at(level):
        return n // level

    for level in (1, 2, 4, 8, 16, 32):
        if level in _PATCH_LEVELS and rows_at(level) % 2:
            raise ValueError(f"space={space}: a slab of {n} of the {height} rows holds "
                             f"{rows_at(level)} rows at /{level}, where the MobileViTv2 "
                             "block's 2x2 patches need an even count")
        if level in _STRIDE2_LEVELS and rows_at(level) % 2:
            raise ValueError(f"space={space}: a slab of {n} of the {height} rows holds "
                             f"{rows_at(level)} rows at /{level}, which the stride-2 conv to "
                             f"/{2 * level} cannot halve on the global grid")
    if model is None:
        return
    windows = [("hourglass_att", 32, model.att_window1)]
    if not model.att_weights_only:
        windows.append(("hourglass", 16, model.att_window2))
    for name, level, window in windows:
        if rows_at(level) % window[1]:
            raise ValueError(f"space={space}: a slab of {n} of the {height} rows holds "
                             f"{rows_at(level)} rows at /{level}, which {name}'s attention "
                             f"windows of {window[1]} rows do not tile")


def check_parallel(cfg: ParallelConfig, world: int, model: ModelConfig | None = None) -> None:
    """Raises ``ValueError`` unless ``cfg`` describes ``data`` x ``disp`` x
    ``space`` processes filling ``world`` (``data`` -1: the rest) and, given
    the model, each of its cost volumes splits into ``disp`` slabs.  The
    rows' split depends on each batch's height, which the model's forward
    holds to ``check_space_rows``."""
    if not cfg.sync_bn:
        raise ValueError("sync_bn=False (per-process BatchNorm statistics) is not ported; "
                         "the data-parallel step takes global statistics, as the JAX "
                         "package does under GSPMD")
    _data_count(cfg.data, cfg.disp, world, cfg.space)
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


def halo_rows(x: torch.Tensor, part: Part, axis: int, below: int, above: int,
              replicate: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(the ``below`` rows before this process's slab ``x``, the ``above``
    rows after it) along ``axis``: the neighbouring slabs' edge rows over
    the group of ``part``; past the ends zeros, or with ``replicate`` copies
    of the end row.  No gradient (``halo_pad`` is the differentiable
    form)."""
    n = x.shape[axis]
    # my last rows are the upper neighbour's "below", my first the lower's "above"
    parts = _all_gather(torch.cat([x.narrow(axis, n - below, below),
                                   x.narrow(axis, 0, above)], axis), part)
    i, last = part.index, part.size - 1

    def end(j, start, rows, edge_row):
        if j is not None:
            return parts[j].narrow(axis, start, rows)
        if replicate:
            return torch.cat([x.narrow(axis, edge_row, 1)] * rows, axis)
        return torch.zeros_like(x.narrow(axis, 0, rows))

    return (end(i - 1 if i > 0 else None, 0, below, 0),
            end(i + 1 if i < last else None, below, above, n - 1))


def add_halo_grads(gx: torch.Tensor, g_lo: torch.Tensor, g_hi: torch.Tensor, part: Part,
                   axis: int, replicate: bool = False) -> torch.Tensor:
    """The adjoint of ``halo_rows``: adds, in place, to this process's slab
    cotangent ``gx`` the cotangents of the halo rows its neighbours took
    from it (``g_lo`` and ``g_hi`` are this process's halo rows' own, sent
    to their owners); with ``replicate`` the end rows also take their
    copies' cotangents.  Returns ``gx``."""
    below, above, n = g_lo.shape[axis], g_hi.shape[axis], gx.shape[axis]
    parts = _all_gather(torch.cat([g_lo, g_hi], axis), part)
    i, last = part.index, part.size - 1
    if below:
        if i < last:  # the upper neighbour's lower halo is my last rows
            gx.narrow(axis, n - below, below).add_(parts[i + 1].narrow(axis, 0, below))
        if i == 0 and replicate:
            gx.narrow(axis, 0, 1).add_(g_lo.sum(axis, keepdim=True))
    if above:
        if i > 0:  # the lower neighbour's upper halo is my first rows
            gx.narrow(axis, 0, above).add_(parts[i - 1].narrow(axis, below, above))
        if i == last and replicate:
            gx.narrow(axis, n - 1, 1).add_(g_hi.sum(axis, keepdim=True))
    return gx


class _HaloPad(torch.autograd.Function):
    """[rows below, x, rows above] along ``axis`` (``halo_rows``);
    backward: each halo's cotangent goes back to its owner and is added to
    the rows it came from (``add_halo_grads``)."""

    @staticmethod
    def forward(ctx, x, part, axis, below, above, replicate):
        ctx.args = (part, axis, below, above, replicate)
        lo, hi = halo_rows(x, part, axis, below, above, replicate)
        return torch.cat([lo, x, hi], axis)

    @staticmethod
    def backward(ctx, g):
        part, axis, below, above, replicate = ctx.args
        n = g.shape[axis] - below - above
        gx = g.narrow(axis, below, n).clone()
        add_halo_grads(gx, g.narrow(axis, 0, below), g.narrow(axis, below + n, above), part,
                       axis, replicate)
        return gx, None, None, None, None, None


def _all_gather(t: torch.Tensor, part: Part) -> list:
    """Each process's ``t`` (equal shapes) gathered over the group of ``part``."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(part.size)]
    dist.all_gather(parts, t, group=part.group)
    return parts


def halo_pad(x: torch.Tensor, part: Part, axis: int, below: int, above: int,
             mode: str = "zeros") -> torch.Tensor:
    """This process's slab ``x`` with ``below`` rows before it and
    ``above`` rows after it along ``axis``, from the neighbouring slabs of
    the group of ``part`` (a ``Mesh``'s ``disp_part`` or ``space_part``),
    differentiably.  Past the ends of the whole: ``mode`` "zeros" (a
    zero-padded conv) or "replicate" (the end row repeated, for the
    edge-clamped resizes and propagation).  A neighbour's slab must hold
    ``below`` and ``above`` rows."""
    if mode not in ("zeros", "replicate"):
        raise ValueError(f"halo mode {mode!r}")
    if not (below or above):
        return x
    if min(below, above) < 0 or max(below, above) > x.shape[axis]:
        raise ValueError(f"a halo of ({below}, {above}) rows around a slab of "
                         f"{x.shape[axis]}")
    return _HaloPad.apply(x, part, axis, below, above, mode == "replicate")


def space_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the space group; differentiable: the adjoint of
    y = sum_p x_p, taken by every process, is the cotangent summed over the
    group (``torch.distributed.nn``'s all-reduce)."""
    if x.requires_grad and torch.is_grad_enabled():
        return dist_fn.all_reduce(x, group=mesh.space_group)
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.space_group)
    return x


def space_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The element-wise max of ``x`` over the space group, without
    gradient."""
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.space_group)
    return x


def gather_rows(x, mesh: Mesh, axis: int = 1):
    """The whole along ``axis`` from each process's slab of rows (a tensor
    or a numpy array), without gradient; the identity without a row
    split."""
    if mesh is None or not mesh.rows:
        return x
    if isinstance(x, np.ndarray):
        return gather_rows(torch.from_numpy(np.ascontiguousarray(x)), mesh, axis).numpy()
    dev = x.device
    t = x.detach()
    if dist.get_backend(mesh.space_group) == "nccl" and dev.type != "cuda":
        t = t.to(_collective_device())
    return torch.cat(_all_gather(t, mesh.space_part), axis).to(dev)


def broadcast_from_group(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` (no gradient) as the disp group's first process holds it: the
    global rank data_index * disp * space + space_index, which
    ``dist.broadcast`` takes as ``src``."""
    t = t.contiguous().clone()
    dist.broadcast(t, src=mesh.data_index * mesh.disp * mesh.space + mesh.space_index,
                   group=mesh.disp_group)
    return t


def _collective_device() -> torch.device:
    """Where the group's collectives take tensors: the card for NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
