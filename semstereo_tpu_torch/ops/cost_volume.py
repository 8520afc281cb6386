"""Cosine group-wise correlation cost volumes.

Counterpart of ``semstereo_tpu/ops/cost_volume.py``.  Layouts are
channels-last: features [B, H, W, C], volume [B, D, H, W, G].  Plane d holds
shift ``d - max_shift`` (symmetric) or ``d`` (positive):
``vol[b,d,h,x,g] = mean_c ln[b,h,x,g,c] * rn[b,h,x-s,g,c]`` for in-range
``x - s``, else 0.  Every function takes a slab of the planes, the
``planes`` planes from ``plane0`` on (the whole range by default): the
part of the volume that one process of a disp group holds.  Each row of
the volume correlates the same row of the two feature maps (shifts run
along W), so under spatial parallelism each process launches both kernels
on its slab of rows as they are, with no halo.

``gwc_volume_norm`` is differentiable.  On CUDA tensors its forward
launches the Hopper kernel ``csrc/gwc_volume.cu`` (K2, which replaces the
TPU kernel ``semstereo_tpu/ops/pallas/cost_volume_kernel.py::_forward``)
and its backward ``csrc/gwc_volume_bwd.cu`` (K4, which replaces ``_bwd``);
each note says what bounds the kernel and what its design does about that.
On CPU tensors they run ``gwc_volume_norm_plain`` and
``gwc_volume_norm_bwd_plain``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from semstereo_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def normalize_groups(feat: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, G, C//G], unit L2 norm per group, with eps
    added to the norm (not to its square)."""
    b, h, w, c = feat.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    g = feat.reshape(b, h, w, num_groups, c // num_groups)
    norm = torch.sqrt(torch.sum(torch.square(g), dim=-1, keepdim=True))
    return g / (norm + eps)


def shift_range(max_shift: int, symmetric: bool) -> tuple[int, int]:
    """(first shift, number of planes)."""
    return (-max_shift, 2 * max_shift) if symmetric else (0, max_shift)


def slab_shifts(max_shift: int, symmetric: bool, plane0: int = 0,
                planes: int | None = None) -> tuple[int, int]:
    """(first shift, number of planes) of the slab of ``planes`` planes
    (None: the rest) from plane ``plane0`` of ``shift_range``."""
    lo, d = shift_range(max_shift, symmetric)
    n = d - plane0 if planes is None else planes
    if plane0 < 0 or n < 1 or plane0 + n > d:
        raise ValueError(f"planes {plane0} .. {plane0 + n - 1} of a {d}-plane volume")
    return lo + plane0, n


def gwc_volume_norm_plain(left, right, max_shift: int, num_groups: int,
                          symmetric: bool = True, plane0: int = 0,
                          planes: int | None = None) -> torch.Tensor:
    """Plain PyTorch version, computed in fp32 and cast to the input dtype.
    left, right [B, H, W, C] -> [B, D, H, W, G] (D the slab's planes)."""
    w = left.shape[2]
    ln = normalize_groups(left.float(), num_groups)
    rn = normalize_groups(right.float(), num_groups)
    lo, d = slab_shifts(max_shift, symmetric, plane0, planes)
    hi = lo + d - 1
    # rp[:, :, j] = rn[:, :, j - max(hi, 0)]; shift s reads columns x - s
    pad_l, pad_r = max(hi, 0), max(-lo, 0)
    rp = F.pad(rn, (0, 0, 0, 0, pad_l, pad_r))
    planes = []
    for s in range(lo, lo + d):
        r_s = rp[:, :, pad_l - s: pad_l - s + w]
        planes.append(torch.mean(ln * r_s, dim=-1))
    return torch.stack(planes, dim=1).to(left.dtype)


def gwc_volume_norm_bwd_plain(left, right, gbar, max_shift: int, num_groups: int,
                              symmetric: bool = True, plane0: int = 0,
                              planes: int | None = None):
    """Both input cotangents of ``gwc_volume_norm``, in closed form in fp32,
    cast to the input dtype.  With u, v the group-normalised left and right
    and cpg = C/G channels per group: yl = sum_d gbar_d/cpg * v[x - s_d],
    yr = sum_d gbar_d[x + s_d]/cpg * u[x + s_d] over the valid columns, then
    the VJP of x -> x/(|x|_g + eps), y/(n+eps) - x (x.y)/(n (n+eps)^2) with
    n clamped at 1e-30.  left, right [B,H,W,C], gbar [B,D,H,W,G] (D the
    slab's planes) -> two [B,H,W,C]."""
    b, h, w, c = left.shape
    g, eps = num_groups, 1e-5
    cpg = c // g
    x_l = left.float().reshape(b, h, w, g, cpg)
    x_r = right.float().reshape(b, h, w, g, cpg)
    n_l = torch.sqrt(torch.sum(torch.square(x_l), dim=-1, keepdim=True))
    n_r = torch.sqrt(torch.sum(torch.square(x_r), dim=-1, keepdim=True))
    u, v = x_l / (n_l + eps), x_r / (n_r + eps)
    gb = gbar.float()[..., None] / cpg  # [B, D, H, W, G, 1]
    y_l, y_r = torch.zeros_like(u), torch.zeros_like(v)
    lo, d = slab_shifts(max_shift, symmetric, plane0, planes)
    for k, s in enumerate(range(lo, lo + d)):
        a, e = max(s, 0), w + min(s, 0)  # columns x with x - s in the image
        if a < e:
            y_l[:, :, a:e] += gb[:, k, :, a:e] * v[:, :, a - s:e - s]
            y_r[:, :, a - s:e - s] += gb[:, k, :, a:e] * u[:, :, a:e]

    def norm_vjp(x, n, y):
        coef = torch.sum(x * y, dim=-1, keepdim=True) / (n.clamp_min(1e-30) * (n + eps) ** 2)
        return (y / (n + eps) - x * coef).reshape(b, h, w, c)

    return (norm_vjp(x_l, n_l, y_l).to(left.dtype), norm_vjp(x_r, n_r, y_r).to(right.dtype))


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry points of ``csrc/gwc_volume.cu`` on ``lib`` (the
    card's build, or the CPU emulator's in the tests)."""
    if lib.gwc_volume.argtypes is None:
        lib.gwc_volume.argtypes = [_P, _P, _P] + [_I] * 8 + [_P]
        lib.gwc_volume.restype = ctypes.c_int
        lib.gwc_volume_smem.argtypes = [_I] * 4
        lib.gwc_volume_smem.restype = ctypes.c_longlong
        lib.gwc_volume_blocks_per_sm.argtypes = [_I] * 4
        lib.gwc_volume_blocks_per_sm.restype = ctypes.c_int
    return lib


def _lib():
    return bind_fwd(_build.load("gwc_volume"))


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry points of ``csrc/gwc_volume_bwd.cu`` on ``lib``
    (the card's build, or the CPU emulator's in the tests)."""
    if lib.gwc_volume_bwd.argtypes is None:
        lib.gwc_volume_bwd.argtypes = [_P] * 7 + [_I] * 8 + [_P]
        lib.gwc_volume_bwd.restype = ctypes.c_int
        lib.gwc_volume_bwd_smem.argtypes = [_I] * 4
        lib.gwc_volume_bwd_smem.restype = ctypes.c_longlong
        lib.gwc_volume_bwd_slabs.argtypes = [_I]
        lib.gwc_volume_bwd_slabs.restype = ctypes.c_int
        lib.gwc_volume_bwd_blocks_per_sm.argtypes = [_I] * 4
        lib.gwc_volume_bwd_blocks_per_sm.restype = ctypes.c_int
    return lib


def _lib_bwd():
    return bind_bwd(_build.load("gwc_volume_bwd"))


# K2's and K4's instantiations: 8 channels per group, G = 32 (the model's) or 8.
_GROUPS = (8, 32)


def _occupancy(what, blocks_per_sm, smem, args):
    n = blocks_per_sm(*args)
    if n < 0:
        raise RuntimeError(f"{what}{args}: CUDA error {-n}")
    return n, smem(*args)


def gwc_volume_occupancy(channels: int, num_groups: int, planes: int,
                         dtype: torch.dtype) -> tuple[int, int]:
    """(blocks per SM, dynamic shared memory bytes per block) of K2 on the
    current card, for features of ``channels`` in ``num_groups`` groups and
    a volume of ``planes`` planes."""
    lib = _lib()
    return _occupancy("gwc_volume_occupancy", lib.gwc_volume_blocks_per_sm, lib.gwc_volume_smem,
                      (channels, num_groups, planes, _DTYPES[dtype]))


def gwc_volume_bwd_occupancy(channels: int, num_groups: int, planes: int,
                             dtype: torch.dtype) -> tuple[int, int]:
    """The same for K4's first launch (one per slab of planes)."""
    lib = _lib_bwd()
    return _occupancy("gwc_volume_bwd_occupancy", lib.gwc_volume_bwd_blocks_per_sm,
                      lib.gwc_volume_bwd_smem, (channels, num_groups, planes, _DTYPES[dtype]))


def _check(left, right, num_groups):
    if left.dim() != 4 or left.shape != right.shape:
        raise ValueError(f"gwc_volume_norm: left {tuple(left.shape)}, right "
                         f"{tuple(right.shape)} (takes two equal [B,H,W,C])")
    if left.shape[3] % num_groups:
        raise ValueError(f"{left.shape[3]} channels do not split into {num_groups} groups")


def _check_cuda(what, num_groups, *ts):
    left = ts[0]
    if left.device.type != "cuda" or any(t.device != left.device for t in ts):
        raise ValueError(f"{what}: no kernel for {[str(t.device) for t in ts]}")
    if left.dtype not in _DTYPES or any(t.dtype != left.dtype for t in ts):
        raise TypeError(f"{what}: {[t.dtype for t in ts]} (takes float32 or bfloat16, alike)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous")
    c = left.shape[3]
    if num_groups not in _GROUPS or c != 8 * num_groups:
        raise ValueError(f"{what}: kernel takes 8 channels per group and G in {_GROUPS}, got "
                         f"C={c}, G={num_groups}")


def gwc_volume_norm_fwd(left, right, max_shift: int, num_groups: int,
                        symmetric: bool = True, plane0: int = 0,
                        planes: int | None = None) -> torch.Tensor:
    """The forward alone: K2 on CUDA tensors (one launch for the slab), the
    plain version on CPU ones."""
    _check(left, right, num_groups)
    lo, d = slab_shifts(max_shift, symmetric, plane0, planes)
    if left.device.type == "cpu":
        return gwc_volume_norm_plain(left, right, max_shift, num_groups, symmetric, plane0, d)
    _check_cuda("gwc_volume_norm", num_groups, left, right)
    b, h, w, c = left.shape
    out = torch.empty((b, d, h, w, num_groups), dtype=left.dtype, device=left.device)
    err = _lib().gwc_volume(
        left.data_ptr(), right.data_ptr(), out.data_ptr(), b, h, w, c, num_groups, lo, d,
        _DTYPES[left.dtype], torch.cuda.current_stream(left.device).cuda_stream,
    )
    _build.check(err, "gwc_volume_norm")
    gwc_volume_norm.launches += 1
    gwc_volume_norm.planes += d
    gwc_volume_norm.rows += h
    return out


def gwc_volume_norm_bwd(left, right, gbar, max_shift: int, num_groups: int,
                        symmetric: bool = True, plane0: int = 0, planes: int | None = None):
    """(d left, d right) of ``gwc_volume_norm`` for the volume's cotangent
    ``gbar`` [B,D,H,W,G] (D the slab's planes): K4 on CUDA tensors (one
    launch per run of at most 17 planes), the plain closed form on CPU
    ones."""
    _check(left, right, num_groups)
    lo, d = slab_shifts(max_shift, symmetric, plane0, planes)
    b, h, w, c = left.shape
    if tuple(gbar.shape) != (b, d, h, w, num_groups):
        raise ValueError(f"gwc_volume_norm_bwd: gbar {tuple(gbar.shape)}, expected "
                         f"{(b, d, h, w, num_groups)}")
    if left.device.type == "cpu":
        return gwc_volume_norm_bwd_plain(left, right, gbar, max_shift, num_groups, symmetric,
                                         plane0, d)
    _check_cuda("gwc_volume_norm_bwd", num_groups, left, right, gbar)
    lib = _lib_bwd()
    smem = lib.gwc_volume_bwd_smem(c, num_groups, d, _DTYPES[left.dtype])
    limit = torch.cuda.get_device_properties(left.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"gwc_volume_norm_bwd: C={c}, G={num_groups}, D={d} needs {smem} "
                         f"bytes of shared memory, the card has {limit}")
    gl, gr = torch.empty_like(left), torch.empty_like(right)
    # D above one slab of planes takes a launch per slab; in bf16 they sum
    # in fp32 workspaces
    slabs = lib.gwc_volume_bwd_slabs(d)
    ws = (torch.empty((2, *left.shape), dtype=torch.float32, device=left.device)
          if slabs > 1 and left.dtype != torch.float32 else None)
    err = lib.gwc_volume_bwd(
        left.data_ptr(), right.data_ptr(), gbar.data_ptr(), gl.data_ptr(), gr.data_ptr(),
        None if ws is None else ws[0].data_ptr(), None if ws is None else ws[1].data_ptr(),
        b, h, w, c, num_groups, lo, d, _DTYPES[left.dtype],
        torch.cuda.current_stream(left.device).cuda_stream,
    )
    _build.check(err, "gwc_volume_norm_bwd")
    gwc_volume_norm_bwd.launches += slabs
    gwc_volume_norm_bwd.planes += d
    gwc_volume_norm_bwd.rows += h
    return gl, gr


class _GwcVolumeNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, left, right, max_shift, num_groups, symmetric, plane0, planes):
        ctx.args = (max_shift, num_groups, symmetric, plane0, planes)
        ctx.save_for_backward(left, right)
        return gwc_volume_norm_fwd(left, right, *ctx.args)

    @staticmethod
    def backward(ctx, gbar):
        left, right = ctx.saved_tensors
        gl, gr = gwc_volume_norm_bwd(left, right, gbar.contiguous(), *ctx.args)
        return gl, gr, None, None, None, None, None


def gwc_volume_norm(left, right, max_shift: int, num_groups: int, symmetric: bool = True,
                    plane0: int = 0, planes: int | None = None) -> torch.Tensor:
    """Cosine group-wise correlation volume, or the slab of ``planes`` of
    its planes from ``plane0`` on, differentiable in both inputs (the
    gradient of the planes outside the slab is not taken); see the module
    docstring."""
    return _GwcVolumeNorm.apply(left, right, max_shift, num_groups, symmetric, plane0, planes)


# Kernel launches of K2 and K4, and the planes and rows they computed (a
# launch's rows counted once, whatever its slabs of planes); the smoke run
# reads them to show that the main path went through the kernels (on one
# process's slab of the planes under disparity parallelism, of the rows
# under spatial parallelism).
gwc_volume_norm.launches = 0
gwc_volume_norm_bwd.launches = 0
gwc_volume_norm.planes = 0
gwc_volume_norm_bwd.planes = 0
gwc_volume_norm.rows = 0
gwc_volume_norm_bwd.rows = 0
