"""The cost-volume kernels' CUDA sources run on the CPU through the emulator
of ``semstereo_tpu_torch.emu`` (g++ against stand-in CUDA headers):

* K2, ``csrc/gwc_volume.cu``, against ``gwc_volume_norm_plain`` and, once,
  against the JAX package's Pallas kernel ``gwc_volume_norm_pallas`` in
  interpret mode: bf16 and fp32, symmetric and positive ranges, widths that
  no tile or segment divides, B = 2, a zero channel group, the model's
  C = 256 / G = 32 at D = 16, G = 8 small shapes, and D = 64 in fp32;
* K4, ``csrc/gwc_volume_bwd.cu``, at plane counts above one slab (D = 20
  in fp32, D = 36 in bf16, and a positive range), against
  ``gwc_volume_norm_bwd_plain``;
* both kernels' shared memory per launch, from their host functions, for
  every D from 1 to 64 in both dtypes, against the card's 232,448 bytes;
* both kernels on the plane slabs that disparity parallelism gives one
  process (one launch each, at ``shift_lo = lo + p0`` and ``D = n``): the
  symmetric D = 16 volume split in two (shifts -8..-1, which hold no zero
  shift, and 0..7) and the positive D = 8 volume split in two (0..3 and
  4..7), against the plain versions' slabs.

Tolerances are the card tests' ``CARD_TOL`` (tests/test_torch_kernels.py):
the kernels sum in fp32 and round once to the input dtype, so bf16 results
are within one bf16 ulp (2^-8) of the plain version's, and fp32 ones differ
only by summation order.  A mutated shift sign, ring slot or wait depth
fails these tests.  The test skips only where there is no ``g++``.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from semstereo_tpu.ops.pallas.cost_volume_kernel import gwc_volume_norm_pallas
from semstereo_tpu_torch import emu
from semstereo_tpu_torch.ops import _build, cost_volume

CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The most dynamic shared memory an H100 block takes.
SMEM_LIMIT = 232_448


def _emu_lib(tmp_path_factory, name):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    return emu.build(_build.CSRC / f"{name}.cu", tmp_path_factory.mktemp("emu"))


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    return cost_volume.bind_fwd(_emu_lib(tmp_path_factory, "gwc_volume"))


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    return cost_volume.bind_bwd(_emu_lib(tmp_path_factory, "gwc_volume_bwd"))


def _features(seed, b, h, w, c, zero_group=False, g=1):
    rng = np.random.default_rng(seed)
    left, right = (torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
                   for _ in range(2))
    if zero_group:
        cpg = c // g
        left[0, 0, 1, cpg:2 * cpg] = 0
        right[0, -1, 2, :cpg] = 0
    return left, right


def _run_k2(k2, left, right, max_shift, g, symmetric):
    b, h, w, c = left.shape
    lo, d = cost_volume.shift_range(max_shift, symmetric)
    out = torch.empty((b, d, h, w, g), dtype=left.dtype)
    err = k2.gwc_volume(left.data_ptr(), right.data_ptr(), out.data_ptr(), b, h, w, c, g, lo, d,
                        _DTYPES[left.dtype], None)
    assert err == 0
    return out


# (B, H, W, C, G, max_shift, symmetric, zero group): G = 8 small shapes in
# both ranges, W that no tile or segment divides, B = 2, zero groups, the
# model's C = 256 / G = 32 at D = 16 in both ranges
K2_CASES = [
    (2, 2, 21, 64, 8, 4, True, False),
    (1, 2, 37, 64, 8, 4, False, False),
    (1, 1, 40, 256, 32, 8, True, False),
    (1, 1, 19, 256, 32, 8, False, True),
    (2, 1, 13, 64, 8, 3, True, True),
]


@pytest.mark.parametrize("b,h,w,c,g,max_shift,symmetric,zero_group,dtype", [
    case + (dtype,) for case in K2_CASES for dtype in (torch.float32, torch.bfloat16)
] + [(1, 1, 70, 64, 8, 32, True, False, torch.float32)])  # D = 64
def test_k2_source_matches_plain_on_cpu(k2, b, h, w, c, g, max_shift, symmetric, zero_group,
                                        dtype):
    left, right = (t.to(dtype) for t in _features(9, b, h, w, c, zero_group, g))
    got = _run_k2(k2, left, right, max_shift, g, symmetric).float()
    want = cost_volume.gwc_volume_norm_plain(left.float(), right.float(), max_shift, g,
                                             symmetric)
    assert ((got - want).abs().max() / want.abs().max()).item() <= CARD_TOL[dtype]


@pytest.mark.parametrize("symmetric", [True, False])
def test_k2_source_matches_pallas_interpret(k2, symmetric):
    left, right = _features(11, 1, 2, 24, 64)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gwc_volume_norm_pallas(jnp.asarray(left.numpy()),
                                                 jnp.asarray(right.numpy()), 4, 8, symmetric))
    got = _run_k2(k2, left, right, 4, 8, symmetric).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CARD_TOL[torch.float32] * np.abs(want).max())


# (B, H, W, G, max_shift, symmetric, dtype): one slab more than the ring of
# one launch holds, in each dtype at the model's C = 256, and a positive
# range, whose later slabs hold no zero shift
K4_CASES = [
    (1, 1, 23, 32, 10, True, torch.float32),
    (1, 1, 19, 32, 18, True, torch.bfloat16),
    (2, 1, 29, 8, 20, False, torch.bfloat16),
    (1, 2, 45, 8, 24, True, torch.float32),
]


@pytest.mark.parametrize("b,h,w,g,max_shift,symmetric,dtype", K4_CASES)
def test_k4_source_takes_large_plane_counts(k4, b, h, w, g, max_shift, symmetric, dtype):
    c = 8 * g
    lo, d = cost_volume.shift_range(max_shift, symmetric)
    assert k4.gwc_volume_bwd_slabs(d) > 1
    assert k4.gwc_volume_bwd_smem(c, g, d, _DTYPES[dtype]) <= SMEM_LIMIT
    left, right = _features(13, b, h, w, c, zero_group=True, g=g)
    gbar = torch.from_numpy(np.random.default_rng(14).standard_normal((b, d, h, w, g))
                            .astype(np.float32))
    for k, s in enumerate(range(lo, lo + d)):  # NaN where x - s leaves the image: unused
        gbar[:, k, :, :max(s, 0)] = float("nan")
        gbar[:, k, :, w + min(s, 0):] = float("nan")
    left, right, gbar = (t.to(dtype) for t in (left, right, gbar))
    gl, gr = torch.empty_like(left), torch.empty_like(right)
    ws = torch.empty((2, b, h, w, c), dtype=torch.float32)
    err = k4.gwc_volume_bwd(left.data_ptr(), right.data_ptr(), gbar.data_ptr(), gl.data_ptr(),
                            gr.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(), b, h, w, c, g, lo,
                            d, _DTYPES[dtype], None)
    assert err == 0
    want = cost_volume.gwc_volume_norm_bwd_plain(left, right, gbar, max_shift, g, symmetric)
    for got, ref in zip((gl, gr), want):
        # relative to the largest |ref| of each (b, h, x, group): a zero
        # group's cotangent is 1/eps times the others'
        got, ref = (t.float().reshape(b, h, w, g, -1) for t in (got, ref))
        scale = ref.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        assert ((got - ref).abs() / scale).max().item() <= CARD_TOL[dtype]


# (B, H, W, C, G, max_shift, symmetric, first plane, planes): the two
# slabs of disp = 2 at the model's symmetric D8 = 16 (C = 256, G = 32) and
# at a positive D = 8 (G = 8), at widths no tile divides; and the first
# slab of a symmetric maxdisp-192 /8 volume at disp 2 (shifts -24..-1),
# which K4 takes in more than one launch, the first of them on a range
# without shift 0
SLAB_CASES = [
    (1, 1, 37, 256, 32, 8, True, 0, 8),
    (1, 1, 37, 256, 32, 8, True, 8, 8),
    (2, 1, 21, 64, 8, 8, False, 0, 4),
    (2, 1, 21, 64, 8, 8, False, 4, 4),
    (1, 2, 45, 64, 8, 24, True, 0, 24),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,g,max_shift,symmetric,p0,n", SLAB_CASES)
def test_k2_and_k4_sources_take_a_plane_slab(k2, k4, dtype, b, h, w, c, g, max_shift,
                                              symmetric, p0, n):
    lo, _ = cost_volume.slab_shifts(max_shift, symmetric, p0, n)
    left, right = (t.to(dtype) for t in _features(17, b, h, w, c, zero_group=True, g=g))
    vol = torch.empty((b, n, h, w, g), dtype=dtype)
    assert k2.gwc_volume(left.data_ptr(), right.data_ptr(), vol.data_ptr(), b, h, w, c, g, lo,
                         n, _DTYPES[dtype], None) == 0
    want = cost_volume.gwc_volume_norm_plain(left.float(), right.float(), max_shift, g,
                                             symmetric, p0, n)
    whole = cost_volume.gwc_volume_norm_plain(left.float(), right.float(), max_shift, g,
                                              symmetric)
    assert torch.equal(want, whole[:, p0:p0 + n])
    assert ((vol.float() - want).abs().max() / want.abs().max()).item() <= CARD_TOL[dtype]

    gbar = torch.from_numpy(np.random.default_rng(18).standard_normal((b, n, h, w, g))
                            .astype(np.float32))
    for k, s in enumerate(range(lo, lo + n)):  # NaN where x - s leaves the image: unused
        gbar[:, k, :, :max(s, 0)] = float("nan")
        gbar[:, k, :, w + min(s, 0):] = float("nan")
    gbar = gbar.to(dtype)
    gl, gr = torch.empty_like(left), torch.empty_like(right)
    ws = torch.empty((2, b, h, w, c), dtype=torch.float32)
    assert k4.gwc_volume_bwd_slabs(n) == (1 if n <= 17 else 2)
    assert k4.gwc_volume_bwd(left.data_ptr(), right.data_ptr(), gbar.data_ptr(), gl.data_ptr(),
                             gr.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(), b, h, w, c, g,
                             lo, n, _DTYPES[dtype], None) == 0
    ref = cost_volume.gwc_volume_norm_bwd_plain(left, right, gbar, max_shift, g, symmetric, p0, n)
    for got, r in zip((gl, gr), ref):
        got, r = (t.float().reshape(b, h, w, g, -1) for t in (got, r))
        scale = r.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        assert ((got - r).abs() / scale).max().item() <= CARD_TOL[dtype]


@pytest.mark.parametrize("kernel", ["k2", "k4"])
def test_shared_memory_per_launch_fits_the_card(request, kernel):
    lib = request.getfixturevalue(kernel)
    smem = lib.gwc_volume_smem if kernel == "k2" else lib.gwc_volume_bwd_smem
    need = {(g, d, t): smem(8 * g, g, d, t) for g in (8, 32) for d in range(1, 65) for t in (0, 1)}
    assert max(need.values()) <= SMEM_LIMIT, max(need.items(), key=lambda kv: kv[1])
    if kernel == "k4":
        # the main path's plane count stays one launch of the 48-column ring
        assert (lib.gwc_volume_bwd_slabs(16), need[32, 16, 1]) == (1, 110_592)
