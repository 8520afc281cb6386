"""K4's CUDA source, ``csrc/gwc_volume_bwd.cu``, run on the CPU through the
emulator of ``semstereo_tpu_torch.emu`` (g++ against stand-in CUDA
headers), against ``gwc_volume_norm_bwd_plain``.

This is the kernel's own indexing, staging and masking, checked where
there is no card: bf16 and fp32, symmetric and positive ranges, widths that
no column tile divides, B = 2, a zero channel group (the norm VJP's 1e-30
clamp), NaN in the gb entries no valid term reads, and both instantiations:
the model's G = 32 (C = 256, D = 16 in both ranges) and G = 8 for small
shapes.  Tolerances are the card tests' ``CARD_TOL``
(tests/test_torch_train_ops.py): bf16 outputs are rounded once from fp32
sums, fp32 ones differ by summation order.  A mutated index, such as the
sign of a shift, a window offset or a ring slot, fails it.  Each case takes
a second or two; the build, once per module, a few seconds.  The test
skips only where there is no ``g++``.
"""

import shutil

import numpy as np
import pytest
import torch

from semstereo_tpu_torch import emu
from semstereo_tpu_torch.ops import _build, cost_volume

CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("emu")
    return cost_volume.bind_bwd(emu.build(_build.CSRC / "gwc_volume_bwd.cu", out))


# (B, H, W, C, G, max_shift, symmetric, zero group)
CASES = [
    (2, 2, 21, 64, 8, 4, True, False),
    (2, 2, 21, 64, 8, 4, False, False),
    (1, 1, 19, 256, 32, 8, True, False),
    (1, 1, 37, 256, 32, 16, False, False),
    (2, 1, 5, 64, 8, 4, True, True),
    (1, 2, 12, 256, 32, 8, True, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,g,max_shift,symmetric,zero_group", CASES)
def test_k4_source_matches_plain_on_cpu(k4, dtype, b, h, w, c, g, max_shift, symmetric,
                                        zero_group):
    rng = np.random.default_rng(7)
    lo, d = cost_volume.shift_range(max_shift, symmetric)
    left, right = (torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
                   for _ in range(2))
    gbar = torch.from_numpy(rng.standard_normal((b, d, h, w, g)).astype(np.float32))
    for k, s in enumerate(range(lo, lo + d)):  # NaN where x - s leaves the image: unused
        gbar[:, k, :, :max(s, 0)] = float("nan")
        gbar[:, k, :, w + min(s, 0):] = float("nan")
    if zero_group:
        cpg = c // g
        left[0, 0, 1, cpg:2 * cpg] = 0
        right[0, -1, 2, :cpg] = 0
    left, right, gbar = (t.to(dtype) for t in (left, right, gbar))
    gl, gr = torch.empty_like(left), torch.empty_like(right)
    err = k4.gwc_volume_bwd(left.data_ptr(), right.data_ptr(), gbar.data_ptr(), gl.data_ptr(),
                            gr.data_ptr(), None, None, b, h, w, c, g, lo, d, _DTYPES[dtype], None)
    assert err == 0
    want = cost_volume.gwc_volume_norm_bwd_plain(left, right, gbar, max_shift, g, symmetric)
    for got, ref in zip((gl, gr), want):
        # relative to the largest |ref| of each (b, h, x, group): a zero
        # group's cotangent is 1/eps times the others'
        got, ref = (t.float().reshape(b, h, w, g, -1) for t in (got, ref))
        scale = ref.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        assert ((got - ref).abs() / scale).max().item() <= CARD_TOL[dtype]
