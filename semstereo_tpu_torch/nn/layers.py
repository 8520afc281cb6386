"""Core blocks, channels-last (counterpart of ``semstereo_tpu/nn/layers.py``).

Tensors are [B, H, W, C] or [B, D, H, W, C].  The convs are torch modules
with the reference's weight layouts and state-dict names; they run on
permuted (channels_last / channels_last_3d strided) views, so no copies are
made around them.  A 3x3x3 pad-1 conv at stride 1 or 2 (``BasicConv(dims=3)``,
the hourglass ``convbn_3d`` and the classifier convs) runs in the volume-conv
kernel; every other conv and deconv stays on ``F.conv*``.

* Eval: BatchNorm is an affine on the channel axis with eps 1e-5, and the
  volume convs run in ``ops.conv3d_bn_act`` with it folded in: ``scale =
  gamma / sqrt(var + 1e-5)``, ``bias = beta - mean * scale``.  What the eval
  forward derives from the weights (the BN affine, the kernel's weight
  layout) is computed once and kept on the module until the weights change
  (``derived``).
* Train: BatchNorm is flax's (``semstereo_tpu/nn/layers.py::batch_norm``):
  batch statistics in fp32 over every axis but the last, output in the
  input's dtype, and the running statistics moved 0.1 of the way to the
  batch mean and the *biased* batch variance.  Under a process group of
  more than one process the batch is the global one: the per-channel sum,
  sum of squared deviations and count are all-reduced, and so are the
  backward's two per-channel sums (``_GlobalBatchNorm``), as GSPMD gives
  the JAX package.  A forward that ``torch.utils.checkpoint``
  recomputes for the backward (``recomputing()``) leaves the running
  statistics alone, as flax's ``nn.remat`` moves them once.  The volume
  convs run in the differentiable ``ops.conv3d`` (no affine), then
  BatchNorm, then ReLU, the order of the JAX package's
  ``BasicConv``/``ConvBn`` in train.
* Plane slabs: given a ``mesh`` whose disp axis splits the volume, a 3-D
  conv takes its input as this process's slab of planes and returns its
  slab of the output planes.  A conv whose kernel spans depth reads the
  neighbouring slabs' edge planes (``parallel.halo_rows``, zeros at the
  volume's ends) and keeps the output planes on the global grid: the
  3x3x3 pad-1 conv runs the kernel on [below, slab, above] at stride 1 and
  on [0, below, slab] at stride 2, the k3 s2 p1 op1 deconv on [slab,
  above], and each drops the output planes outside the slab (2 at stride
  1, 1 at stride 2, 2 for the deconv).  A conv of kernel depth 1 takes the
  slab as it is.  BatchNorm's statistics are global over the processes, so
  a slab's counts add up to the volume's.
* Row slabs: on a module that ``split_rows`` gave a mesh whose space axis
  splits the images, every conv takes this process's slab of rows (axis 1
  of [B, H, W, C], axis 2 of [B, D, H, W, C]) and returns its slab of the
  output rows, by the same rules along H: a conv of kernel height k,
  stride 1 and padding p reads p rows below and k - 1 - p above (the 3x3
  convs, the depthwise 3x3, the 3x3x3 volume convs and the (1, 3, 3)
  patch conv: one each side); the k3 s2 p1 conv runs on [0, below, slab];
  the k4 s2 p1 deconv on [below, slab, above], keeping output rows 2 ..
  2n + 1; the k3 s2 p1 op1 volume deconv on [slab, above].  The halo rows
  are zeros past the image, as the conv's own padding.  1x1 convs take the
  slab as it is.
* Both slabs take one path: the volume convs go to K1 (and their backward
  to K3) on the haloed slab, with the extra output planes or rows dropped.
  The haloed conv is one autograd node (``_SlabConv``; the eval kernel
  with its folded BN apart) that keeps the slab and its few halo rows for
  the backward, not the haloed copy, which it builds again there: a copy
  kept beside the slab, which the layer before keeps too, would hold as
  much memory as the slab split saves.  BatchNorm's statistics over the
  world are those of the whole volume or images, as every process holds
  distinct planes or rows.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import torch
import torch.distributed as dist
import torch.nn as nn

from semstereo_tpu_torch.parallel import add_halo_grads, halo_rows, process_count

from semstereo_tpu_torch.ops.conv3d import conv3d, conv3d_backward, conv3d_bn_act, conv3d_forward
from semstereo_tpu_torch.ops.resize import resize_bilinear


def derived(module: nn.Module, dtype: torch.dtype, sources, make):
    """``make()``, kept on ``module`` while ``dtype`` and the tensors in
    ``sources`` stay as they are: the same tensor objects, with the same
    storage and version.  An in-place write (loading weights included)
    moves a tensor's version; ``.to()`` gives it new storage; a tensor made
    anew (the casts handed to ``functional_call``) is another object even
    where it lands in a freed one's memory at its version."""
    key = (dtype, *((t.device, t.data_ptr(), t._version) for t in sources))
    hit = module.__dict__.get("_derived")
    if hit is None or hit[0] != key or any(r() is not t for r, t in zip(hit[1], sources)):
        hit = module.__dict__["_derived"] = (key, [weakref.ref(t) for t in sources], make())
    return hit[2]


# Weight of the batch statistics in the running average (flax momentum 0.9).
BN_MOMENTUM = 0.1

# Set on the thread that recomputes a checkpointed forward in the backward.
_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """The forward run inside is a recomputation: BatchNorm normalises as
    before but does not move its running statistics again."""
    depth = getattr(_recompute, "depth", 0)
    _recompute.depth = depth + 1
    try:
        yield
    finally:
        _recompute.depth = depth


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (torch BatchNorm names: weight, bias,
    running_mean, running_var); see the module docstring for the two modes."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale, shift) with y = x * scale + shift."""
        scale = self.weight.detach().float() / torch.sqrt(self.running_var.float() + self.eps)
        shift = self.bias.detach().float() - self.running_mean.float() * scale
        return scale, shift

    def forward(self, x):
        if self.training:
            return self._train(x)
        scale, shift = derived(self, x.dtype, (self.weight, self.bias, self.running_mean,
                                               self.running_var),
                               lambda: tuple(t.to(x.dtype) for t in self.fold()))
        return torch.addcmul(shift, x, scale)

    def _train(self, x):
        if process_count() > 1:
            y, mean, var = self._train_global(x)
        else:
            # One reduction serves both uses: native_batch_norm normalises by
            # the biased batch statistics and returns the mean and
            # 1/sqrt(var + eps) it used, in fp32 for a bf16 input given fp32
            # weights.  It is not given the running buffers, which it would
            # move by the unbiased variance.
            y, mean, invstd = torch.native_batch_norm(
                x.reshape(-1, x.shape[-1]), self.weight.float(), self.bias.float(), None,
                None, True, 0.0, self.eps)
            y = y.reshape(x.shape)
            var = invstd.detach().pow(-2) - self.eps
        if not getattr(_recompute, "depth", 0):
            with torch.no_grad():
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(mean.detach(), alpha=BN_MOMENTUM)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(var.detach(), alpha=BN_MOMENTUM)
        return y

    def _train_global(self, x):
        """(y, mean, biased variance) over the rows of every process
        (``_GlobalBatchNorm``)."""
        y, mean, var = _GlobalBatchNorm.apply(x.reshape(-1, x.shape[-1]), self.weight,
                                              self.bias, self.eps)
        return y.reshape(x.shape), mean, var


class _GlobalBatchNorm(torch.autograd.Function):
    """Train BatchNorm of x [N, C] over the rows of every process, as one
    node: the forward all-reduces the per-channel sum with the count, then
    the squared deviations from the global mean, and normalises in fp32;
    it keeps x in its own dtype and the per-channel statistics.  The
    backward all-reduces the two per-channel sums of the standard formula,
    dx = w / sigma (g - mean(g) - xhat mean(g xhat)) over the global batch
    (each process holds its rows' full cotangent), and returns the
    parameters' gradients of this process's rows, which the gradient
    all-reduce sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.float()
        sums = torch.cat([xf.sum(0), torch.full((1,), float(xf.shape[0]), device=xf.device)])
        dist.all_reduce(sums)
        n = sums[-1]
        mean = sums[:-1] / n
        sq = (xf - mean).square().sum(0)
        dist.all_reduce(sq)
        var = sq / n
        invstd = torch.rsqrt(var + eps)
        y = ((xf - mean) * (invstd * weight.float()) + bias.float()).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        g = gy.float()
        xhat = (x.float() - mean) * invstd
        gb, gw = g.sum(0), (g * xhat).sum(0)
        sums = torch.cat([gb, gw])
        dist.all_reduce(sums)
        c = gb.shape[0]
        gx = (weight.float() * invstd) * (g - sums[:c] / n - xhat * (sums[c:] / n))
        return gx.to(x.dtype), gw.to(weight.dtype), gb.to(weight.dtype), None


def split_rows(module: nn.Module, mesh) -> nn.Module:
    """Gives ``module`` and every submodule the mesh whose space axis splits
    the rows (``None`` unless ``mesh.space`` is above 1); see the module
    docstring.  The mesh is a plain attribute, not a submodule or a
    buffer."""
    rows = mesh if mesh is not None and mesh.rows else None
    for m in module.modules():
        m.__dict__["row_mesh"] = rows
    return module


def rows_of(module: nn.Module):
    """The mesh that splits ``module``'s rows, or None."""
    return module.__dict__.get("row_mesh")


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    nd = x.dim() - 2
    y = conv(x.permute(0, nd + 1, *range(1, nd + 1)))
    return y.permute(0, *range(2, nd + 2), 1)


def conv_cl(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Run a torch conv module (NC... layout) on a channels-last tensor;
    on the row slab of a module split by rows, with its halo."""
    rows = rows_of(conv)
    if rows is None or conv.kernel_size[-2] == 1:
        return _conv(conv, x)
    return _SlabConv.apply(x, conv.weight, conv.bias, conv, rows.space_part, x.dim() - 3)


def _kernel_train(conv: nn.Module) -> bool:
    """Whether the conv is a train-mode volume conv of the kernel (K1, K3)."""
    return _is_k3_volume_conv(conv) and conv.training


def _conv_nc(conv: nn.Module, x: torch.Tensor, weight, bias) -> torch.Tensor:
    """The conv of a channels-last ``x`` with ``weight`` and ``bias``, as the
    module computes it (``aten.convolution``), channels-last."""
    nd = x.dim() - 2
    y = torch.ops.aten.convolution(
        x.permute(0, nd + 1, *range(1, nd + 1)), weight, bias, conv.stride, conv.padding,
        conv.dilation, conv.transposed, conv.output_padding, conv.groups)
    return y.permute(0, *range(2, nd + 2), 1)


class _SlabConv(torch.autograd.Function):
    """A conv on this process's slab ``x`` (channels-last) of planes or rows
    along ``axis``, with its halo (``_slab_rule``), as one node: it keeps ``x`` and the halo rows, not the
    haloed copy, and builds that again in the backward.  The train-mode
    volume convs run K1 forward and K3 backward (``ops.conv3d``); the rest
    ``aten.convolution`` and its backward.  The halo rows' cotangents go
    back to their owners (``parallel.add_halo_grads``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv, part, axis):
        front, below, above, keep = _slab_rule(conv, x.shape[axis], axis)
        lo, hi = halo_rows(x, part, axis, below, above)
        xp = _assemble(x, lo, hi, front, axis)
        if _kernel_train(conv):
            y = conv3d_forward(xp, weight, conv.stride[0])
        else:
            y = _conv_nc(conv, xp, weight, bias)
        ctx.conv, ctx.part, ctx.axis, ctx.rule, ctx.full = conv, part, axis, (
            front, below, above, keep), y.shape
        ctx.save_for_backward(x, lo, hi, weight, bias)
        return y.narrow(axis, *keep)

    @staticmethod
    def backward(ctx, gy):
        x, lo, hi, weight, bias = ctx.saved_tensors
        conv, axis = ctx.conv, ctx.axis
        front, below, above, keep = ctx.rule
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        xp = _assemble(x, lo, hi, front, axis)
        g = gy.new_zeros(ctx.full)
        g.narrow(axis, *keep).copy_(gy)
        gb = None
        if _kernel_train(conv):
            gxp, gw = conv3d_backward(xp, weight, g, conv.stride[0], need_x, need_w)
        else:
            nd = x.dim() - 2
            nc = (0, nd + 1, *range(1, nd + 1))
            gxp, gw, gb = torch.ops.aten.convolution_backward(
                g.permute(*nc), xp.permute(*nc), weight,
                None if bias is None else [bias.shape[0]], conv.stride, conv.padding,
                conv.dilation, conv.transposed, conv.output_padding, conv.groups,
                [need_x, need_w, need_b and bias is not None])
            if gxp is not None:
                gxp = gxp.permute(0, *range(2, nd + 2), 1)
        gx = None
        if need_x:
            n = x.shape[axis]
            gx = add_halo_grads(gxp.narrow(axis, front + below, n),
                                gxp.narrow(axis, front, below),
                                gxp.narrow(axis, front + below + n, above), ctx.part, axis)
        return gx, gw, gb, None, None, None


def _is_k3_volume_conv(conv: nn.Module) -> bool:
    return (
        type(conv) is nn.Conv3d
        and conv.kernel_size == (3, 3, 3)
        and conv.padding == (1, 1, 1)
        and conv.stride in ((1, 1, 1), (2, 2, 2))
        and conv.dilation == (1, 1, 1)
        and conv.groups == 1
        and conv.bias is None
    )


def kernel_operands(conv: nn.Conv3d, bn: BatchNorm | None):
    """The kernel's weight [3, 3, 3, C, F] and fp32 scale and bias [F]: the
    folded BN, or 1 and 0 without one."""
    w = conv.weight.detach().permute(2, 3, 4, 1, 0).contiguous()
    if bn is not None:
        return (w, *bn.fold())
    ones = torch.ones(conv.out_channels, dtype=torch.float32, device=w.device)
    return w, ones, torch.zeros_like(ones)


def _slab_rule(conv: nn.Module, n: int, axis: int):
    """(zero rows before the halo, halo rows below, halo rows above, (first,
    count) of the output rows to keep) of the conv on a slab of ``n`` rows
    along ``axis``; see the module docstring."""
    j = axis - 1  # the axis's place in the kernel's spatial dims
    k, s, p = conv.kernel_size[j], conv.stride[j], conv.padding[j]
    if isinstance(conv, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        op = conv.output_padding[j]
        if (k, s, p, op) == (4, 2, 1, 0):
            return 0, 1, 1, (2, 2 * n)
        if (k, s, p, op) == (3, 2, 1, 1):
            return 0, 0, 1, (0, 2 * n)
    elif s == 1 and 0 <= p <= k - 1:
        return 0, p, k - 1 - p, (p, n)
    elif (k, s, p) == (3, 2, 1) and n % 2 == 0:
        return 1, 1, 0, (1, n // 2)
    raise ValueError(f"no slab rule for {conv} on a slab of {n}")


def _assemble(x, lo, hi, front: int, axis: int) -> torch.Tensor:
    """[front zero rows, lo, x, hi] along ``axis``."""
    parts = [lo, x, hi]
    if front:
        parts.insert(0, torch.zeros_like(x.narrow(axis, 0, front)))
    return torch.cat(parts, axis)


def _halo(conv: nn.Module, x: torch.Tensor, part, axis: int):
    """(the input the conv takes for the slab ``x`` along ``axis``, (first,
    count) of the output rows to keep), without gradient: the eval kernel's
    input, as ``_SlabConv`` builds it."""
    front, below, above, keep = _slab_rule(conv, x.shape[axis], axis)
    lo, hi = halo_rows(x, part, axis, below, above)
    return _assemble(x, lo, hi, front, axis), keep


def conv_bn_act(conv: nn.Module, bn: BatchNorm | None, x: torch.Tensor,
                relu: bool, mesh=None) -> torch.Tensor:
    """[relu](bn(conv(x))); a 3x3x3 pad-1 volume conv goes to the kernel,
    with the BN folded in eval.  With a ``mesh`` that splits the volume,
    x and the result are this process's plane slabs; on a module split by
    rows, its row slabs (module docstring)."""
    rows = rows_of(conv)
    split = None
    if mesh is not None and mesh.split and conv.kernel_size[0] > 1:
        split = mesh.disp_part, 1
    elif rows is not None and conv.kernel_size[-2] > 1:
        split = rows.space_part, x.dim() - 3
    kernel = _is_k3_volume_conv(conv)
    if kernel and not conv.training:  # the eval kernel, with the BN folded in
        keep = None
        if split is not None:
            x, keep = _halo(conv, x, *split)
        sources = (conv.weight,) if bn is None else (
            conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        w, scale, shift = derived(conv, conv.weight.dtype, sources,
                                  lambda: kernel_operands(conv, bn))
        y = conv3d_bn_act(x.contiguous(), w, scale, shift, conv.stride[0], relu)
        return y if keep is None else y.narrow(split[1], *keep)
    if split is not None:
        y = _SlabConv.apply(x, conv.weight, conv.bias, conv, *split)
    elif kernel:
        y = conv3d(x, conv.weight, conv.stride[0])
    else:
        y = _conv(conv, x)
    if bn is not None:
        y = bn(y)
    return torch.relu(y) if relu else y


def make_conv(cin: int, cout: int, k, stride=1, padding=0, dims: int = 2, deconv=False,
              output_padding=0, bias: bool = False) -> nn.Module:
    if deconv:
        cls = nn.ConvTranspose3d if dims == 3 else nn.ConvTranspose2d
        return cls(cin, cout, k, stride, padding, output_padding, bias=bias)
    cls = nn.Conv3d if dims == 3 else nn.Conv2d
    return cls(cin, cout, k, stride, padding, bias=bias)


class BasicConv(nn.Module):
    """(De)conv without bias + BN + ReLU (children ``conv``, ``bn``)."""

    def __init__(self, cin: int, cout: int, kernel_size=3, stride=1, padding=0, dims=2,
                 deconv=False):
        super().__init__()
        self.conv = make_conv(cin, cout, kernel_size, stride, padding, dims, deconv)
        self.bn = BatchNorm(cout)

    def forward(self, x, mesh=None):
        return conv_bn_act(self.conv, self.bn, x, relu=True, mesh=mesh)


class ConvBn(nn.Sequential):
    """Sequential(conv, BN): children ``0`` and ``1`` (reference ``convbn_3d``
    and the ``chal_*`` reductions)."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0, dims=2,
                 bias=False, deconv=False, output_padding=0):
        super().__init__(
            make_conv(cin, cout, kernel_size, stride, padding, dims, deconv, output_padding,
                      bias=bias),
            BatchNorm(cout),
        )

    def forward(self, x, relu: bool = False, mesh=None):
        return conv_bn_act(self[0], self[1], x, relu, mesh)


class Conv2x(nn.Module):
    """k4 s2 p1 deconv (exact x2 upsample), bilinear shape-fix to the skip,
    concat, 3x3 conv (``conv1``, ``conv2``); output has 2 * ``cout`` channels."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = BasicConv(cin, cout, 4, 2, 1, deconv=True)
        self.conv2 = BasicConv(2 * cout, 2 * cout, 3, 1, 1)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[1:-1] != rem.shape[1:-1]:
            x = resize_bilinear(x, rem.shape[1:3], rows_of(self))
        return self.conv2(torch.cat([x, rem], dim=-1))
