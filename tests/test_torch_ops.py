"""The port's plain ops (semstereo_tpu_torch.ops) against their JAX
counterparts in semstereo_tpu.ops, on the CPU in fp32.

Inputs are drawn with numpy and handed to both packages.  Tolerances:
rtol = atol = 1e-5 for elementwise and gather ops (the same fp32 arithmetic
in another order), 1e-4 where the op reduces over channels (sums of up to
a few hundred fp32 terms taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semstereo_tpu.ops import cost_volume as jcv
from semstereo_tpu.ops import propagation as jprop
from semstereo_tpu.ops import regression as jreg
from semstereo_tpu.ops import resize as jres
from semstereo_tpu.ops import warp as jwarp
from semstereo_tpu_torch.ops import cost_volume, propagation, regression, resize, warp

TIGHT = dict(rtol=1e-5, atol=1e-5)
REDUCE = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TIGHT):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# --- resize -----------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((4, 6), (8, 12)), ((5, 7), (20, 28)), ((3, 3), (7, 5))])
def test_resize_bilinear(src, dst):
    x = _rand(0, (2, *src, 3))
    _close(resize.resize_bilinear(torch.from_numpy(x), dst), jres.resize_bilinear(x, dst))


@pytest.mark.parametrize("src,dst", [((4, 4, 6), (8, 16, 24)), ((2, 3, 5), (4, 12, 20))])
def test_resize_trilinear(src, dst):
    x = _rand(1, (1, *src, 2))
    _close(resize.resize_trilinear(torch.from_numpy(x), dst), jres.resize_trilinear(x, dst))


# --- regression -------------------------------------------------------------


@pytest.mark.parametrize("symmetric", [True, False])
def test_disparity_values(symmetric):
    _close(regression.disparity_values(8, symmetric), jreg.disparity_values(8, symmetric))


@pytest.mark.parametrize("symmetric", [True, False])
def test_regression_and_variance(symmetric):
    raw = _rand(2, (2, 16, 5, 7), 3.0)
    prob_t = torch.softmax(torch.from_numpy(raw), dim=1)
    prob_j = np.asarray(prob_t)
    d_t = regression.disparity_regression(prob_t, symmetric)
    d_j = jreg.disparity_regression(prob_j, symmetric)
    _close(d_t, d_j, REDUCE)
    _close(regression.disparity_variance(prob_t, d_t, symmetric),
           jreg.disparity_variance(prob_j, d_j, symmetric), REDUCE)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("k", [4, 12])
def test_topk_planes(symmetric, k):
    raw = _rand(3, (2, 16, 6, 5), 2.0)  # continuous values: no ties
    got = regression.topk_planes(torch.from_numpy(raw), k, symmetric)
    want = jreg.topk_planes(jnp.asarray(raw), k, symmetric)
    for g, w in zip(got, want):
        _close(g, w)


def test_regression_topk():
    cost = _rand(4, (2, 24, 6, 5), 2.0)
    samples = _rand(5, (2, 24, 6, 5), 10.0)
    _close(regression.regression_topk(torch.from_numpy(cost), torch.from_numpy(samples), 2),
           jreg.regression_topk(jnp.asarray(cost), jnp.asarray(samples), 2))


def test_regression_topk_breaks_ties_as_lax_top_k():
    cost = np.round(_rand(4, (2, 24, 6, 5), 2.0)) + 0.0  # many exact ties, no signed zeros
    samples = _rand(5, (2, 24, 6, 5), 10.0)
    _close(regression.regression_topk(torch.from_numpy(cost), torch.from_numpy(samples), 2),
           jreg.regression_topk(jnp.asarray(cost), jnp.asarray(samples), 2))


@pytest.mark.parametrize("symmetric", [True, False])
def test_topk_planes_breaks_ties_as_lax_top_k(symmetric):
    """Equal weights enter the top k lower plane first, as lax.top_k has it
    (which also orders -0.0 below +0.0; the grid here has no signed zeros)."""
    raw = np.round(_rand(6, (2, 16, 6, 5), 1.5)) + 0.0
    got = regression.topk_planes(torch.from_numpy(raw), 5, symmetric)
    want = jreg.topk_planes(jnp.asarray(raw), 5, symmetric)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("symmetric", [True, False])
def test_topk_planes_gradient(symmetric):
    """The VJP of all three outputs at k < D (continuous inputs: no ties),
    against ``jax.vjp``: a fault in the gather's backward or in the index
    order moves the gradient onto other planes."""
    raw = _rand(13, (2, 16, 6, 5), 2.0)
    cots = [_rand(14 + i, (2, 5, 6, 5)) for i in range(3)]
    w = torch.from_numpy(raw).requires_grad_()
    outs = regression.topk_planes(w, 5, symmetric)[:2]  # samples carry no gradient
    (got,) = torch.autograd.grad(outs, w, [torch.from_numpy(c) for c in cots[:2]])
    _, vjp = jax.vjp(lambda x: jreg.topk_planes(x, 5, symmetric), jnp.asarray(raw))
    (want,) = vjp(tuple(jnp.asarray(c) for c in cots))
    _close(got, want)


def test_regression_topk_gradient():
    """Both input gradients at k = 2 of 24 planes against ``jax.vjp``."""
    cost, samples = _rand(17, (2, 24, 6, 5), 2.0), _rand(18, (2, 24, 6, 5), 10.0)
    cot = _rand(19, (2, 6, 5))
    c, s = (torch.from_numpy(a).requires_grad_() for a in (cost, samples))
    got = torch.autograd.grad(regression.regression_topk(c, s, 2), (c, s), torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a, b: jreg.regression_topk(a, b, 2), jnp.asarray(cost),
                     jnp.asarray(samples))
    for g, w in zip(got, vjp(jnp.asarray(cot))):
        _close(g, w, REDUCE)


def test_topk_rejects_k_above_planes():
    with pytest.raises(ValueError):
        regression.topk_planes(torch.zeros(1, 4, 2, 2), 5, True)


# --- propagation ------------------------------------------------------------


def test_propagate5():
    x = _rand(6, (2, 5, 7))
    _close(propagation.propagate5(torch.from_numpy(x)), jprop.propagate5(x))


def test_propagate5_volume():
    x = _rand(7, (2, 3, 5, 7))
    _close(propagation.propagate5_volume(torch.from_numpy(x)), jprop.propagate5_volume(x))


# --- warp -------------------------------------------------------------------


def _warp_inputs(seed, symmetric):
    rng = np.random.default_rng(seed)
    right = rng.standard_normal((2, 5, 24, 8)).astype(np.float32)
    left = rng.standard_normal((2, 5, 24, 8)).astype(np.float32)
    lo, hi = (-6, 6) if symmetric else (-12, 0)
    # disparity d maps to source offset -d; keep offsets inside the band
    disp = rng.uniform(-hi, -lo, (2, 5, 5, 24)).astype(np.float32)
    return left, right, disp, lo, hi


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("impl", ["gather", "shifts"])
def test_disparity_warp(symmetric, impl):
    _, right, disp, lo, hi = _warp_inputs(8, symmetric)
    want = jwarp.disparity_warp(right, disp, impl=impl, max_offset=hi, min_offset=lo)
    _close(warp.disparity_warp(torch.from_numpy(right), torch.from_numpy(disp)), want)


def test_disparity_warp_coordinates_stay_fp32_under_bf16():
    """bf16 disparities at |x| >= 128 must still give bilinear (not
    nearest) weights: the coordinates are computed in fp32."""
    right = torch.arange(300, dtype=torch.float32).repeat(1, 1, 1, 1).reshape(1, 1, 300, 1)
    disp = torch.full((1, 1, 1, 300), 2.5).to(torch.bfloat16)
    out = warp.disparity_warp(right.to(torch.bfloat16), disp)[0, 0, 0, :, 0].float()
    np.testing.assert_allclose(out[200:210].numpy(), np.arange(197.5, 207.5), rtol=1e-2)


@pytest.mark.parametrize("symmetric", [True, False])
def test_warp_strength(symmetric):
    left, right, disp, lo, hi = _warp_inputs(9, symmetric)
    want = jwarp.warp_strength(left, right, disp, hi, lo)
    got = warp.warp_strength(torch.from_numpy(left), torch.from_numpy(right),
                             torch.from_numpy(disp), hi, lo)
    _close(got, want, REDUCE)


def test_warp_strength_is_mean_of_warp():
    left, right, disp, lo, hi = _warp_inputs(10, True)
    lt, rt, dt = map(torch.from_numpy, (left, right, disp))
    direct = torch.mean(lt[:, None] * warp.disparity_warp(rt, dt), dim=-1)
    _close(warp.warp_strength(lt, rt, dt, hi, lo), direct, REDUCE)


def test_warp_with_left():
    left, right, disp, lo, hi = _warp_inputs(11, True)
    got = warp.warp_with_left(torch.from_numpy(left), torch.from_numpy(right),
                              torch.from_numpy(disp))
    want = jwarp.warp_with_left(left, right, disp, impl="gather")
    for g, w in zip(got, want):
        _close(g, w)


# --- cost volume ------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_normalize_groups(groups):
    x = _rand(12, (2, 3, 5, 16))
    _close(cost_volume.normalize_groups(torch.from_numpy(x), groups),
           jcv.normalize_groups(x, groups), REDUCE)


def test_normalize_groups_eps_on_the_norm():
    """eps is added to the norm, not to its square: a zero group stays 0 and
    a tiny one is damped by 1e-5 against its norm."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1e-5
    got = cost_volume.normalize_groups(x, 1)[..., 0, 0].item()
    assert got == pytest.approx(0.5, rel=1e-5)
