"""``fuse_views``: the eval forward with both views stacked through the
shared front end (``feature``, ``feature_up``, ``chal_1``, ``chal_2``,
``concat_feature``), on the CPU in fp32 at 64x64 with the tiny config and
numpy weights (perturbed BN statistics, x8 classifier output kernels, an
integer-shift pair, as tests/test_torch_model.py makes them).

* Fused against the port's two-pass eval: BN uses its running statistics
  in eval, so only the convs' summation order differs (a batch of 2 where
  there was 1): max |fused - two-pass| / max |two-pass| <= 1e-5 for the
  labels; for the disparity, whose peaked posteriors amplify that
  rounding, median |diff| <= 1e-5 px and max <= 1e-3 px (measured 2.9e-6
  and 2.2e-4).
* Fused against the JAX package's ``fuse_views=True`` eval with the same
  weights: the bounds of tests/test_torch_model.py (labels rtol 1e-3, atol
  2e-3; disparity median |diff| < 0.01 px, p75 < 0.1 px, < 8 % of pixels
  off by more than 1 px, on columns >= 16).
* Train mode ignores it: the train forward with ``fuse_views=True`` equals
  the two-pass one exactly, and so do the running statistics it moves.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semstereo_tpu.models import SemStereo as JaxSemStereo
from semstereo_tpu_torch.config import ModelConfig
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.models import SemStereo, build_model
from tests._torch_threads import two_torch_threads  # noqa: F401

H = W = 64
XMIN = 16
MODEL = dict(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2))


def _numpy_variables(jmodel, seed):
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy,
                                                 train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['mean']"):
            v = 0.1 * rng.standard_normal(shape)
        elif name.endswith("['var']"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("['scale']"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith(("['bias']", "['gamma']")):
            v = 0.05 * rng.standard_normal(shape)
        elif name.endswith("['beta']"):
            v = np.full(shape, 2.0)
        else:
            fan_out = int(np.prod(shape[:-2])) * shape[-1] if len(shape) > 2 else shape[-1]
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    v["params"]["classif_att"]["conv1"]["kernel"] *= 8.0
    v["params"]["classif"]["conv1"]["kernel"] *= 8.0
    return v["params"], v["batch_stats"]


@pytest.fixture(scope="module")
def runs():
    jmodel = JaxSemStereo(**MODEL, fuse_views=True)
    params, stats = _numpy_variables(jmodel, seed=4)
    rng = np.random.default_rng(9)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    left = np.roll(right, 5, axis=2)
    jout = jax.jit(lambda l, r: jmodel.apply({"params": params, "batch_stats": stats}, l, r,
                                             train=False))(left, right)
    model = SemStereo(**MODEL).eval()
    load_flax_variables(model, params, stats)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    two_pass = model(lt, rt)
    model.fuse_views = True
    fused = model(lt, rt)
    return dict(jax={k: np.asarray(v[0] if isinstance(v, tuple) else v)
                     for k, v in jout.items()},
                two_pass=two_pass, fused=fused)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_fused_eval_equals_two_pass(runs):
    for key in ("label_l", "label_r"):
        assert _rel(runs["fused"][key], runs["two_pass"][key]) <= 1e-5, key
    diff = (runs["fused"]["disp"][0] - runs["two_pass"]["disp"][0]).abs()
    assert diff.median() <= 1e-5 and diff.max() <= 1e-3


def test_fused_eval_equals_jax_fused_eval(runs):
    got, want = runs["fused"], runs["jax"]
    np.testing.assert_allclose(got["label_l"].numpy(), want["label_l"], rtol=1e-3, atol=2e-3)
    diff = np.abs(got["disp"][0].numpy() - want["disp"])[:, :, XMIN:]
    assert np.median(diff) < 0.01 and np.quantile(diff, 0.75) < 0.1
    assert np.mean(diff > 1.0) < 0.08


def test_train_mode_ignores_fuse_views():
    cfg = ModelConfig(**MODEL)
    model = build_model(cfg, device="cpu", seed=3).train()
    fused = copy.deepcopy(model)
    fused.fuse_views = True
    rng = np.random.default_rng(2)
    left, right = (torch.from_numpy(rng.standard_normal((2, H, W, 3)).astype(np.float32))
                   for _ in range(2))
    a, b = model(left, right), fused(left, right)
    for key in a:
        for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (a[key], b[key]))):
            assert torch.equal(x, y), key
    for (n, x), y in zip(model.named_buffers(), fused.buffers()):
        assert torch.equal(x, y), n
