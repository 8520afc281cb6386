"""The plain versions of the port's two kernels against the JAX package, on
the CPU in fp32, and the kernels against their plain versions on the card.

* K2, ``gwc_volume_norm``: against ``gwc_volume_norm_xla`` and the Pallas
  kernel ``gwc_volume_norm_pallas`` in interpret mode.
* K1, ``conv3d_bn_act``: against ``conv3d_wl_affine`` (Pallas, interpret
  mode) at the lane-legal model shapes of tests/test_pallas_conv3d.py, and
  against ``lax.conv_general_dilated`` at F=1 and at odd D/H/W.

Tolerance 1e-4 (rtol and atol): both sides reduce 27*C (conv) or C/G
(volume) fp32 products in different orders.  The card tests skip here (no
CUDA device); ``chip_smoke.py`` runs the same comparisons at the main
path's shapes, and on a machine with a card and no JAX
``python3 -m pytest --noconftest tests/test_torch_kernels.py`` runs the
card tests (the JAX comparisons skip there).
"""

import numpy as np
import pytest
import torch

from semstereo_tpu_torch.ops import conv3d, cost_volume

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def jx():
    """The JAX side, imported per test so that the card tests also run
    where JAX is not installed (``pytest --noconftest``)."""
    jax = pytest.importorskip("jax")
    from jax import lax
    from jax.experimental.pallas import tpu as pltpu

    from semstereo_tpu.ops.cost_volume import gwc_volume_norm_xla
    from semstereo_tpu.ops.pallas import conv3d_wl
    from semstereo_tpu.ops.pallas.cost_volume_kernel import gwc_volume_norm_pallas

    def lax_conv(x, k, stride):
        return lax.conv_general_dilated(x, k, (stride,) * 3, [(1, 1)] * 3,
                                        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))

    return dict(jnp=jax.numpy, pltpu=pltpu, gwc_xla=gwc_volume_norm_xla, wl=conv3d_wl,
                gwc_pallas=gwc_volume_norm_pallas, lax_conv=lax_conv)


def _conv_inputs(seed, xshape, f):
    rng = np.random.default_rng(seed)
    c = xshape[-1]
    x = rng.standard_normal(xshape).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, c, f)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (f,)).astype(np.float32)
    bias = (rng.standard_normal((f,)) * 0.1).astype(np.float32)
    return x, k, scale, bias


def _port_conv(x, k, scale, bias, stride, relu):
    return conv3d.conv3d_bn_act(*map(torch.from_numpy, (x, k, scale, bias)), stride, relu)


# --- K2 plain ---------------------------------------------------------------


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("b,h,w,c,groups,max_shift", [(1, 4, 16, 32, 4, 4), (2, 3, 20, 64, 8, 6)])
def test_gwc_plain_matches_xla(jx, symmetric, b, h, w, c, groups, max_shift):
    rng = np.random.default_rng(20)
    left = rng.standard_normal((b, h, w, c)).astype(np.float32)
    right = rng.standard_normal((b, h, w, c)).astype(np.float32)
    want = jx["gwc_xla"](left, right, max_shift, groups, symmetric)
    got = cost_volume.gwc_volume_norm(torch.from_numpy(left), torch.from_numpy(right),
                                      max_shift, groups, symmetric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("symmetric", [True, False])
def test_gwc_plain_matches_pallas_interpret(jx, symmetric):
    rng = np.random.default_rng(21)
    left = rng.standard_normal((1, 4, 16, 32)).astype(np.float32)
    right = rng.standard_normal((1, 4, 16, 32)).astype(np.float32)
    jnp = jx["jnp"]
    with jx["pltpu"].force_tpu_interpret_mode():
        want = jx["gwc_pallas"](jnp.asarray(left), jnp.asarray(right), 4, 4, symmetric)
    got = cost_volume.gwc_volume_norm_plain(torch.from_numpy(left), torch.from_numpy(right),
                                            4, 4, symmetric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gwc_rejects_bad_groups():
    with pytest.raises(ValueError):
        cost_volume.gwc_volume_norm(torch.zeros(1, 2, 4, 30), torch.zeros(1, 2, 4, 30), 2, 4)


# --- K1 plain ---------------------------------------------------------------

# scaled-depth versions of the flagship shapes (tests/test_pallas_conv3d.py)
MODEL_SHAPES = [
    ((1, 4, 8, 128, 32), 32, 1),   # classif/classif_att conv0
    ((1, 4, 8, 128, 64), 32, 1),   # concat_stem 64->32
    ((1, 4, 4, 128, 64), 64, 1),   # hourglass conv2 64->64
    ((1, 4, 8, 256, 32), 64, 2),   # hourglass conv1 32->64 s2
]


@pytest.mark.parametrize("xshape,f,stride", MODEL_SHAPES)
def test_conv_plain_matches_pallas_affine(jx, xshape, f, stride):
    x, k, scale, bias = _conv_inputs(30, xshape, f)
    jnp = jx["jnp"]
    with jx["pltpu"].force_tpu_interpret_mode():
        want = jx["wl"].conv3d_wl_affine(jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale),
                                   jnp.asarray(bias), stride, True)
    got = _port_conv(x, k, scale, bias, stride, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("xshape,f,stride", [
    ((2, 6, 8, 10, 32), 1, 1),     # Cout=1 classifier conv
    ((1, 5, 7, 9, 16), 1, 1),      # odd D/H/W
    ((1, 5, 7, 9, 16), 12, 2),     # odd D/H/W at stride 2
    ((2, 3, 6, 5, 8), 8, 2),
])
@pytest.mark.parametrize("relu", [False, True])
def test_conv_plain_matches_lax(jx, xshape, f, stride, relu):
    x, k, scale, bias = _conv_inputs(31, xshape, f)
    want = np.asarray(jx["lax_conv"](x, k, stride)) * scale + bias
    if relu:
        want = np.maximum(want, 0.0)
    got = _port_conv(x, k, scale, bias, stride, relu)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv_rejects_bad_arguments():
    x = torch.zeros(1, 4, 4, 4, 8)
    ones = torch.ones(4)
    with pytest.raises(ValueError):
        conv3d.conv3d_bn_act(x, torch.zeros(3, 3, 3, 4, 4), ones, ones)  # C mismatch
    with pytest.raises(ValueError):
        conv3d.conv3d_bn_act(x, torch.zeros(3, 3, 3, 8, 4), ones, ones, stride=3)
    with pytest.raises(ValueError):
        conv3d.conv3d_bn_act(x, torch.zeros(3, 3, 3, 8, 4), torch.ones(5), ones)


def _change_in_place(m, other):
    with torch.no_grad():
        m.conv.weight.add_(0.1)
        m.bn.running_var.mul_(2.0)


def _change_by_loading(m, other):
    m.load_state_dict(other.state_dict())


def _change_storage(m, other):
    # as .to() does: new storage under the same parameter, same version
    m.conv.weight.data = other.conv.weight.data.clone()
    m.bn.bias.data = other.bn.bias.data.clone()


@pytest.mark.parametrize("change", [_change_in_place, _change_by_loading, _change_storage])
@pytest.mark.parametrize("dims", [3, 2])
def test_derived_operands_follow_weight_changes(change, dims):
    """The folded BN and the kernel's weight layout are kept on the module
    (``nn.layers.derived``); after any change to the weights a module must
    compute what a fresh module with the same state computes."""
    from semstereo_tpu_torch.nn import BasicConv

    torch.manual_seed(0)
    m, other = (BasicConv(8, 8, 3, 1, 1, dims=dims) for _ in range(2))
    with torch.no_grad():
        for mod in (m, other):
            mod.bn.running_mean.uniform_(-0.5, 0.5)
            mod.bn.bias.uniform_(-0.5, 0.5)
    x = torch.randn((1, 4, 5, 6, 8) if dims == 3 else (1, 5, 6, 8))
    before = m(x)
    change(m, other)
    fresh = BasicConv(8, 8, 3, 1, 1, dims=dims)
    fresh.load_state_dict(m.state_dict())
    got, want = m(x), fresh(x)
    assert not torch.allclose(got, before)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- the kernels on the card ------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16 results are rounded once from fp32 sums: 1 bf16 ulp (2^-8) relative.
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# both strides at each tile width of csrc/conv3d.cu (16, 32, 64 columns;
# weights by cp.async or, for F % 8 != 0, plain loads), ragged tiles, and
# several channel chunks
@pytest.mark.parametrize("xshape,f,stride", [
    ((1, 8, 32, 32, 32), 64, 2), ((1, 8, 64, 64, 32), 64, 1), ((1, 12, 40, 36, 64), 64, 1),
    ((1, 4, 16, 16, 64), 128, 2), ((1, 6, 32, 32, 128), 128, 1), ((1, 6, 16, 16, 64), 32, 1),
    ((1, 6, 16, 16, 32), 1, 1), ((2, 5, 7, 9, 40), 3, 2), ((1, 3, 5, 7, 16), 40, 1),
])
def test_conv_kernel_matches_plain(cuda, dtype, xshape, f, stride):
    x, k, scale, bias = _conv_inputs(40, xshape, f)
    xt, kt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, k))
    st, bt = (torch.from_numpy(a).to(cuda) for a in (scale, bias))
    got = conv3d.conv3d_bn_act(xt, kt, st, bt, stride, True).float()
    torch.cuda.synchronize()
    want = conv3d.conv3d_bn_act_plain(xt, kt, st, bt, stride, True).float()
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= CARD_TOL[dtype]


def test_conv_kernel_rejects_bf16_with_ragged_channels(cuda):
    x = torch.zeros(1, 3, 5, 7, 12, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(3, 3, 3, 12, 4, dtype=torch.bfloat16, device=cuda)
    ones = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="C % 8"):
        conv3d.conv3d_bn_act(x, w, ones, ones)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gwc_kernel_matches_plain(cuda, dtype, symmetric):
    rng = np.random.default_rng(41)
    left, right = (torch.from_numpy(rng.standard_normal((2, 8, 40, 256)).astype(np.float32))
                   .to(cuda, dtype) for _ in range(2))
    got = cost_volume.gwc_volume_norm(left, right, 8, 32, symmetric).float()
    torch.cuda.synchronize()
    want = cost_volume.gwc_volume_norm_plain(left.float(), right.float(), 8, 32, symmetric)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= CARD_TOL[dtype]
