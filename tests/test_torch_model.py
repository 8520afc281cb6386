"""The port's SemStereo eval graph against the JAX package's, on the CPU in
fp32, with the same weights: H=W=128, maxdisp 64, stage 2 and stage 1
(``att_weights_only``), and stages 1 and 2 of the positive-range WHU model.

Weights come from numpy (He-normal kernels, BN statistics and affine
perturbed), shaped by the JAX model's ``eval_shape``, and go to JAX as they
are and to the port through ``load_flax_variables``.  The 3-D classifier
kernels are scaled x8 and the pair is an integer-shift stereo pair, so the
disparity posteriors are peaked and the top-k planes are set by the
arithmetic rather than by rounding noise.

Bounds (the scheme of tests/test_model_parity_torch.py):
* ``label_l`` within rtol 1e-3, atol 2e-3: fp32 reassociation through ~40
  convs, some of which the JAX eval graph rewrites (folded stem, fused
  classifier, depthwise shift-MAD);
* disparity on columns >= 32: median |diff| < 0.01 px, p75 < 0.1 px, bulk
  bias < 0.01 px, and fewer than 8 % of pixels off by > 1 px, because
  planes whose weights tie to within fp32 rounding can enter the top k in
  one run and not in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semstereo_tpu.models import SemStereo as JaxSemStereo
from semstereo_tpu.utils.torch_convert import convert_semstereo_state_dict
from semstereo_tpu_torch.config import ModelConfig
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.models import SemStereo, build_model
from tests._torch_threads import two_torch_threads  # noqa: F401

H = W = 128
MAXDISP = 64
XMIN = 32


def _numpy_variables(jmodel, seed):
    """Flax variable trees with numpy values, shaped by ``eval_shape``."""
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy,
                                                 train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['mean']"):
            v = 0.1 * rng.standard_normal(shape)
        elif name.endswith("['var']"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("['scale']"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("['bias']"):
            v = 0.05 * rng.standard_normal(shape)
        elif name.endswith("['gamma']"):
            v = 0.1 * rng.standard_normal(shape)
        elif name.endswith("['beta']"):
            v = np.full(shape, 2.0)
        else:  # kernels: He-normal over fan_out
            fan_out = int(np.prod(shape[:-2])) * shape[-1] if len(shape) > 2 else shape[-1]
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    params, stats = v["params"], v["batch_stats"]
    params["classif_att"]["conv1"]["kernel"] *= 8.0
    if "classif" in params:
        params["classif"]["conv1"]["kernel"] *= 8.0
    return params, stats


def _stereo_pair(seed):
    rng = np.random.default_rng(seed)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    left = np.roll(right, int(rng.integers(4, 14)), axis=2)
    return left, right


def _run(att_weights_only, symmetric=True):
    jmodel = JaxSemStereo(maxdisp=MAXDISP, num_classes=6, att_weights_only=att_weights_only,
                          symmetric=symmetric)
    params, stats = _numpy_variables(jmodel, seed=1 + att_weights_only)
    left, right = _stereo_pair(7)
    out = jax.jit(lambda l, r: jmodel.apply({"params": params, "batch_stats": stats}, l, r,
                                            train=False))(left, right)
    model = SemStereo(maxdisp=MAXDISP, num_classes=6, att_weights_only=att_weights_only,
                      symmetric=symmetric).eval()
    n = load_flax_variables(model, params, stats)
    got = model(torch.from_numpy(left), torch.from_numpy(right))
    return dict(jax=jax.tree_util.tree_map(np.asarray, out), port=got, model=model,
                params=params, stats=stats, n_loaded=n)


@pytest.fixture(scope="module")
def stage2():
    return _run(att_weights_only=False)


@pytest.fixture(scope="module")
def stage1():
    return _run(att_weights_only=True)


@pytest.fixture(scope="module")
def whu_stage1():
    """Positive disparity range (SemStereo_WHU); its /8 volume has 8 planes,
    so the attention window pads D."""
    return _run(att_weights_only=True, symmetric=False)


@pytest.fixture(scope="module")
def whu_stage2():
    """The whole positive-range model (stage 2 of the WHU recipes)."""
    return _run(att_weights_only=False, symmetric=False)


def _assert_disp_close(got, ref):
    signed = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    diff = np.abs(signed)
    bulk = diff < 0.5
    assert float(np.median(diff)) < 0.01
    assert float(np.quantile(diff, 0.75)) < 0.1
    assert abs(float(signed[bulk].mean())) < 0.01
    assert float((diff > 1.0).mean()) < 0.08


@pytest.mark.parametrize("stage", ["stage2", "stage1", "whu_stage1", "whu_stage2"])
def test_eval_parity(stage, request):
    r = request.getfixturevalue(stage)
    got_disp = r["port"]["disp"][0].numpy()
    ref_disp = r["jax"]["disp"][0]
    assert got_disp.shape == ref_disp.shape == (1, H, W)
    assert np.isfinite(got_disp).all()
    for key in ("label_l", "label_r"):
        np.testing.assert_allclose(r["port"][key].numpy(), r["jax"][key], rtol=1e-3, atol=2e-3)
    _assert_disp_close(got_disp[:, :, XMIN:], ref_disp[:, :, XMIN:])


@pytest.mark.parametrize("stage", ["stage2", "stage1"])
def test_load_fills_every_leaf(stage, request):
    r = request.getfixturevalue(stage)
    n_flax = len(jax.tree_util.tree_leaves((r["params"], r["stats"])))
    assert r["n_loaded"] == n_flax == len(r["model"].state_dict())


def test_state_dict_round_trips_through_jax_converter(stage2):
    """The port's state_dict carries the reference torch names: the JAX
    package's own converter maps it back to the same flax arrays."""
    params, stats, unused = convert_semstereo_state_dict(stage2["model"].state_dict())
    assert unused == []
    want = dict(jax.tree_util.tree_flatten_with_path((stage2["params"], stage2["stats"]))[0])
    got = dict(jax.tree_util.tree_flatten_with_path((params, stats))[0])
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("maxdisp,symmetric", [(40, True), (48, False)])
def test_maxdisp_must_give_divisible_attention_volume(maxdisp, symmetric):
    with pytest.raises(ValueError, match="multiple of"):
        SemStereo(maxdisp=maxdisp, symmetric=symmetric)


def test_stereo_requires_seg():
    with pytest.raises(ValueError, match="requires seg_if"):
        SemStereo(seg_if=False, stereo_if=True)


def test_build_model_runs_on_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(ModelConfig())
    model = build_model(ModelConfig(att_weights_only=True), device="cpu")
    assert not model.training
    assert next(model.parameters()).device.type == "cpu"


def test_whu_registry_is_positive_range():
    from semstereo_tpu_torch.models import __models__

    assert __models__["SemStereo_WHU"](maxdisp=64).symmetric is False
    assert __models__["SemStereo"](maxdisp=64).symmetric is True
