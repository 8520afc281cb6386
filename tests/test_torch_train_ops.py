"""The train graph's kernels and BatchNorm against the JAX package, on the
CPU in fp32, and the kernels against their plain versions on the card.

* K3, ``ops.conv3d`` (forward and backward through the same autograd
  Function the card runs, with the plain versions inside): against
  ``conv3d_wl`` and its custom VJP in Pallas interpret mode at the shapes
  of tests/test_pallas_conv3d.py, and at Cout=1 against the VJP of
  ``lax.conv_general_dilated``.  Tolerance rtol 1e-4 and atol 1e-3 on the
  gradients (dw sums thousands of fp32 products in another order), 1e-4
  on y.
  ``conv3d_weight_grad_plain`` (the dw that CPU tensors take) alone against
  the kernel gradient of ``lax.conv_general_dilated``'s VJP, stride 1 and
  2, Cout=1 included.
* K4, the backward of ``ops.gwc_volume_norm``: against the gradient of
  ``gwc_volume_norm_pallas`` (its Pallas backward) in interpret mode,
  symmetric and positive, with one all-zero channel group, rtol 1e-4,
  atol 1e-5, as tests/test_pallas_cost_volume.py holds the Pallas kernel.
* Train-mode BatchNorm: output, input and parameter gradients and the
  running statistics after two calls against flax's BatchNorm (the JAX
  package's ``batch_norm(train=True)``), rtol = atol = 1e-5.

Every side gets the same cotangent, drawn with numpy.  The card tests skip
here (no CUDA device); ``chip_smoke.py`` runs the same comparisons at the
main path's shapes.
"""

import numpy as np
import pytest
import torch

from semstereo_tpu_torch.nn import BatchNorm
from semstereo_tpu_torch.ops import cost_volume
from semstereo_tpu_torch.ops.conv3d import (
    conv3d,
    conv3d_input_grad_s1,
    conv3d_plain,
    conv3d_weight_grad,
    conv3d_weight_grad_plain,
    out_dims,
)

GRAD_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture
def jx():
    """The JAX side, imported per test so that the card tests also run
    where JAX is not installed (``pytest --noconftest``)."""
    jax = pytest.importorskip("jax")
    from jax import lax
    from jax.experimental.pallas import tpu as pltpu

    from semstereo_tpu.nn.layers import batch_norm
    from semstereo_tpu.ops.pallas import conv3d_wl
    from semstereo_tpu.ops.pallas.cost_volume_kernel import gwc_volume_norm_pallas

    return dict(jax=jax, jnp=jax.numpy, lax=lax, pltpu=pltpu, wl=conv3d_wl,
                gwc_pallas=gwc_volume_norm_pallas, batch_norm=batch_norm)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _port_conv_vjp(x, k, gy, stride, relu):
    """y, dx, dw (dw in the JAX layout [3,3,3,C,F]) of the port's conv3d."""
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2))).requires_grad_()
    y = conv3d(xt, wt, stride, relu)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(gy))
    return y.detach().numpy(), dx.numpy(), dw.permute(2, 3, 4, 1, 0).numpy()


# --- K3 ------------------------------------------------------------------


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("stride,xshape,f", [(1, (1, 2, 4, 128, 32), 32),
                                             (2, (1, 2, 4, 256, 32), 64)])
def test_conv3d_vjp_matches_pallas(jx, stride, xshape, f, relu):
    rng = np.random.default_rng(50)
    x = _rand(rng, xshape)
    k = _rand(rng, (3, 3, 3, xshape[-1], f), 0.1)
    ys = (xshape[0], *out_dims(*xshape[1:4], stride), f)
    gy = _rand(rng, ys)
    jnp = jx["jnp"]
    with jx["pltpu"].force_tpu_interpret_mode():
        y_j, vjp = jx["jax"].vjp(lambda a, b: jx["wl"].conv3d_wl(a, b, stride, relu),
                                 jnp.asarray(x), jnp.asarray(k))
        dx_j, dk_j = vjp(jnp.asarray(gy))
    y, dx, dw = _port_conv_vjp(x, k, gy, stride, relu)
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx, np.asarray(dx_j), **GRAD_TOL)
    np.testing.assert_allclose(dw, np.asarray(dk_j), **GRAD_TOL)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("xshape,f,stride", [((2, 6, 8, 10, 32), 1, 1),
                                             ((1, 5, 7, 9, 8), 4, 2)])
def test_conv3d_vjp_matches_lax(jx, xshape, f, stride, relu):
    """The Cout=1 classifier conv, whose stride-1 dx is a conv with one input
    channel, and odd extents at stride 2 (output padding 0)."""
    rng = np.random.default_rng(51)
    x = _rand(rng, xshape)
    k = _rand(rng, (3, 3, 3, xshape[-1], f), 0.1)
    gy = _rand(rng, (xshape[0], *out_dims(*xshape[1:4], stride), f))
    lax, jnp = jx["lax"], jx["jnp"]

    def ref(a, b):
        y = lax.conv_general_dilated(a, b, (stride,) * 3, [(1, 1)] * 3,
                                     dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
        return jnp.maximum(y, 0.0) if relu else y

    y_j, vjp = jx["jax"].vjp(ref, jnp.asarray(x), jnp.asarray(k))
    dx_j, dk_j = vjp(jnp.asarray(gy))
    y, dx, dw = _port_conv_vjp(x, k, gy, stride, relu)
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx, np.asarray(dx_j), **GRAD_TOL)
    np.testing.assert_allclose(dw, np.asarray(dk_j), **GRAD_TOL)


@pytest.mark.parametrize("xshape,f,stride", [((2, 4, 6, 10, 8), 1, 1), ((1, 5, 7, 9, 16), 3, 2)])
def test_conv3d_weight_grad_plain_matches_lax(jx, xshape, f, stride):
    rng = np.random.default_rng(57)
    x = _rand(rng, xshape)
    k = _rand(rng, (3, 3, 3, xshape[-1], f), 0.1)
    gy = _rand(rng, (xshape[0], *out_dims(*xshape[1:4], stride), f))
    lax, jnp = jx["lax"], jx["jnp"]

    def ref(b):
        return lax.conv_general_dilated(jnp.asarray(x), b, (stride,) * 3, [(1, 1)] * 3,
                                        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))

    _, vjp = jx["jax"].vjp(ref, jnp.asarray(k))
    (dk_j,) = vjp(jnp.asarray(gy))
    dw = conv3d_weight_grad_plain(torch.from_numpy(x), torch.from_numpy(gy), stride)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dk_j), **GRAD_TOL)


def test_conv3d_counts_no_launch_on_the_cpu():
    before = (conv3d_input_grad_s1.launches, conv3d_weight_grad.launches)
    x = torch.randn(1, 3, 4, 5, 8, requires_grad=True)
    w = torch.randn(4, 8, 3, 3, 3, requires_grad=True)
    conv3d(x, w).sum().backward()
    assert (conv3d_input_grad_s1.launches, conv3d_weight_grad.launches) == before
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


def test_conv3d_weight_grad_rejects_a_misshapen_gy_and_other_devices():
    x = torch.zeros(1, 5, 6, 7, 8)
    with pytest.raises(ValueError, match="gy"):
        conv3d_weight_grad(x, torch.zeros(1, 5, 6, 6, 4), 1)
    with pytest.raises(ValueError, match="gy"):
        conv3d_weight_grad(x, torch.zeros(1, 5, 6, 7, 4), 2)
    with pytest.raises(ValueError, match="no kernel"):
        conv3d_weight_grad(x.to("meta"), torch.zeros(1, 5, 6, 7, 4, device="meta"), 1)


def test_conv3d_rejects_a_non_3x3x3_weight():
    with pytest.raises(ValueError, match="3,3,3"):
        conv3d(torch.zeros(1, 3, 4, 5, 8), torch.zeros(4, 8, 1, 3, 3))


# --- K4 ------------------------------------------------------------------


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("b,h,w,c,groups,max_shift", [(1, 4, 16, 32, 4, 4),
                                                      (1, 2, 16, 16, 2, 2)])
def test_gwc_backward_matches_pallas(jx, symmetric, b, h, w, c, groups, max_shift):
    rng = np.random.default_rng(52)
    left, right = _rand(rng, (b, h, w, c)), _rand(rng, (b, h, w, c))
    left[0, 1, 3, : c // groups] = 0.0  # a zero group: the norm VJP's clamp at 1e-30
    d = 2 * max_shift if symmetric else max_shift
    gbar = _rand(rng, (b, d, h, w, groups))
    jnp = jx["jnp"]
    with jx["pltpu"].force_tpu_interpret_mode():
        _, vjp = jx["jax"].vjp(
            lambda a, r: jx["gwc_pallas"](a, r, max_shift, groups, symmetric),
            jnp.asarray(left), jnp.asarray(right))
        gl_j, gr_j = vjp(jnp.asarray(gbar))
    lt, rt = (torch.from_numpy(a).requires_grad_() for a in (left, right))
    y = cost_volume.gwc_volume_norm(lt, rt, max_shift, groups, symmetric)
    gl, gr = torch.autograd.grad(y, (lt, rt), torch.from_numpy(gbar))
    np.testing.assert_allclose(gl.numpy(), np.asarray(gl_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gr.numpy(), np.asarray(gr_j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("symmetric", [True, False])
def test_gwc_backward_plain_is_the_vjp_of_the_plain_forward(symmetric):
    """The closed form against autograd of the plain forward, in fp64."""
    rng = np.random.default_rng(53)
    left, right = rng.standard_normal((2, 3, 12, 16)), rng.standard_normal((2, 3, 12, 16))
    lt, rt = (torch.from_numpy(a).requires_grad_() for a in (left, right))
    y = cost_volume.gwc_volume_norm_plain(lt, rt, 3, 4, symmetric)
    gbar = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    want = torch.autograd.grad(y, (lt, rt), gbar)
    got = cost_volume.gwc_volume_norm_bwd_plain(lt.detach(), rt.detach(), gbar, 3, 4, symmetric)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-6, atol=1e-6)


def test_gwc_backward_rejects_a_misshapen_cotangent():
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="gbar"):
        cost_volume.gwc_volume_norm_bwd(x, x, torch.zeros(1, 4, 2, 8, 2), 4, 2)


# --- train-mode BatchNorm --------------------------------------------------


def test_batchnorm_train_matches_flax(jx):
    """Two calls in train mode: each output and its gradients, and the
    running statistics after both (moved by the biased batch variance)."""
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(54)
    c = 8
    xs = [_rand(rng, (2, 3, 5, 7, c)) * 3.0 + 1.5 for _ in range(2)]
    gys = [_rand(rng, x.shape) for x in xs]
    scale = 1.0 + 0.1 * _rand(rng, (c,))
    bias = 0.1 * _rand(rng, (c,))
    mean0, var0 = 0.1 * _rand(rng, (c,)), rng.uniform(0.5, 1.5, c).astype(np.float32)

    bn_j = jx["batch_norm"](True)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    for x, gy in zip(xs, gys):
        def f(p, a, s=stats):
            return bn_j.apply({"params": p, "batch_stats": s}, a, mutable=["batch_stats"])

        y_j, vjp, mut = jax.vjp(f, params, jnp.asarray(x), has_aux=True)
        gp_j, gx_j = vjp(jnp.asarray(gy))
        stats = mut["batch_stats"]

        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt)
        gx, gw, gb = torch.autograd.grad(y, (xt, bn.weight, bn.bias), torch.from_numpy(gy))
        tol = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **tol)
        np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(gw.numpy(), np.asarray(gp_j["scale"]), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(gb.numpy(), np.asarray(gp_j["bias"]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5,
                               atol=1e-6)


def test_batchnorm_train_keeps_fp32_statistics_under_bf16():
    """bf16 in, bf16 out; the statistics are reduced and kept in fp32."""
    torch.manual_seed(0)
    x = torch.randn(4, 6, 6, 16) * 2 + 3
    bn = BatchNorm(16).train()
    y = bn(x.bfloat16())
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    xb = x.bfloat16().float().reshape(-1, 16)
    torch.testing.assert_close(bn.running_mean, 0.1 * xb.mean(0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * xb.var(0, correction=0),
                               rtol=1e-5, atol=1e-5)


def test_batchnorm_train_keeps_fp32_statistics_under_bf16_weights():
    """As the train step runs it, on bf16 casts of the weights: the same
    fp32 statistics, and fp32 gradients back to the master weights."""
    torch.manual_seed(0)
    x = torch.randn(4, 6, 6, 16) * 2 + 3
    bn = BatchNorm(16).train()
    params = {n: p.to(torch.bfloat16) for n, p in bn.named_parameters()}
    y = torch.func.functional_call(bn, params, (x.bfloat16(),))
    y.float().square().sum().backward()
    assert y.dtype == torch.bfloat16 and bn.weight.grad.dtype == torch.float32
    xb = x.bfloat16().float().reshape(-1, 16)
    torch.testing.assert_close(bn.running_mean, 0.1 * xb.mean(0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * xb.var(0, correction=0),
                               rtol=1e-5, atol=1e-5)


# --- the kernels on the card -----------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16 results are rounded once from fp32 sums: 1 bf16 ulp (2^-8) relative.
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _max_rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# the dw kernel's edges: voxel counts that no 4 x 32 (stride 1) or 2 x 32
# (stride 2) tile divides, F = 1 (one n8 column tile), C = 8, stride 2 with
# odd extents, batch 2, and D = 2, fewer planes than the K1 plane ring
CONV_GRAD_SHAPES = [
    ((2, 8, 32, 32, 32), 64, 2), ((2, 8, 32, 32, 64), 64, 1), ((2, 6, 16, 16, 32), 1, 1),
    ((1, 5, 7, 9, 16), 8, 2), ((2, 5, 7, 9, 8), 1, 1), ((2, 7, 9, 11, 8), 24, 2),
    ((2, 2, 6, 70, 32), 32, 1), ((1, 3, 5, 36, 128), 128, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,f,stride", CONV_GRAD_SHAPES)
def test_conv3d_kernel_backward_matches_plain(cuda, dtype, xshape, f, stride):
    rng = np.random.default_rng(55)
    x = torch.from_numpy(_rand(rng, xshape)).to(cuda, dtype).requires_grad_()
    w = torch.from_numpy(_rand(rng, (f, xshape[-1], 3, 3, 3), 0.1)).to(cuda, dtype)
    w.requires_grad_()
    y = conv3d(x, w, stride)
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, w), gy)
    y_p = conv3d_plain(x, w, stride)
    want = torch.autograd.grad(y_p, (x, w), gy)
    torch.cuda.synchronize()
    assert _max_rel(y, y_p) <= CARD_TOL[dtype]
    for g, w_ in zip(got, want):
        assert g.dtype == dtype
        assert _max_rel(g, w_) <= CARD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,f,stride", CONV_GRAD_SHAPES)
def test_conv3d_weight_grad_kernel_matches_plain(cuda, dtype, xshape, f, stride):
    rng = np.random.default_rng(58)
    x = torch.from_numpy(_rand(rng, xshape)).to(cuda, dtype)
    gy = torch.from_numpy(_rand(rng, (xshape[0], *out_dims(*xshape[1:4], stride), f)))
    gy = gy.to(cuda, dtype)
    before = conv3d_weight_grad.launches
    got = conv3d_weight_grad(x, gy, stride)
    torch.cuda.synchronize()
    assert conv3d_weight_grad.launches == before + 1
    want = conv3d_weight_grad_plain(x.float(), gy.float(), stride)
    assert got.dtype == dtype and got.shape == want.shape
    assert _max_rel(got, want) <= CARD_TOL[dtype]


# K4's edges at the model's C = 256, G = 32: (B, H, W, max_shift, symmetric,
# zero group).  The US3D range (16 planes) and its positive twin, widths
# that no 8-column tile divides (40, 130, 17), B = H = 1, the WHU positive
# range at 16 planes, and an all-zero channel group (the 1e-30 clamp).
GWC_BWD_CASES = [
    (2, 8, 40, 8, True, False), (2, 8, 40, 8, False, False), (2, 3, 130, 8, True, False),
    (1, 1, 40, 8, True, False), (1, 1, 17, 8, False, False), (2, 4, 72, 16, False, False),
    (1, 2, 40, 8, True, True),
]
# Plane counts above one launch's slab, the smallest that one launch could
# not hold before: D = 20 in fp32 and D = 36 in bf16 (symmetric).
GWC_BWD_LARGE_D = [(2, 3, 40, 10, True, False, torch.float32),
                   (1, 2, 130, 18, True, True, torch.bfloat16)]


@pytest.mark.parametrize("b,h,w,max_shift,symmetric,zero_group,dtype", [
    case + (dtype,) for case in GWC_BWD_CASES for dtype in (torch.float32, torch.bfloat16)
] + GWC_BWD_LARGE_D)
def test_gwc_kernel_backward_matches_plain(cuda, b, h, w, max_shift, symmetric, zero_group,
                                           dtype):
    rng = np.random.default_rng(56)
    left, right = (torch.from_numpy(_rand(rng, (b, h, w, 256))) for _ in range(2))
    lo, d = cost_volume.shift_range(max_shift, symmetric)
    gbar = torch.from_numpy(_rand(rng, (b, d, h, w, 32)))
    for k, s in enumerate(range(lo, lo + d)):  # NaN where x - s leaves the image: unused
        gbar[:, k, :, :max(s, 0)] = float("nan")
        gbar[:, k, :, w + min(s, 0):] = float("nan")
    if zero_group:
        left[0, 0, 3, 8:16] = 0
        right[0, -1, 5, :8] = 0
    left, right, gbar = (t.to(cuda, dtype) for t in (left, right, gbar))
    before = cost_volume.gwc_volume_norm_bwd.launches
    got = cost_volume.gwc_volume_norm_bwd(left, right, gbar, max_shift, 32, symmetric)
    torch.cuda.synchronize()
    # one launch per slab of planes: one at D = 16
    slabs = cost_volume._lib_bwd().gwc_volume_bwd_slabs(d)
    assert (d <= 16) == (slabs == 1)
    assert cost_volume.gwc_volume_norm_bwd.launches == before + slabs
    want = cost_volume.gwc_volume_norm_bwd_plain(left, right, gbar, max_shift, 32, symmetric)
    for g, w_ in zip(got, want):
        assert g.dtype == dtype
        # relative to the largest |want| of each (b, h, x, group): a zero
        # group's cotangent is 1/eps times the others'
        g, w_ = (t.float().reshape(b, h, w, 32, 8) for t in (g, w_))
        scale = w_.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        assert ((g - w_).abs() / scale).max().item() <= CARD_TOL[dtype]
