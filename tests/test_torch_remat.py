"""``remat``: a train step that recomputes components in the backward
against the plain step, on the CPU, from the same state and batch.

Recomputation changes what is kept, not what is computed: the same forward
runs again on the same inputs.  So the loss terms, the gradients and the BN
running statistics must come out as the plain step's:

* fp32, for each of ``full``, ``backbone``, ``featup``, ``hourglass``,
  ``concat`` and ``spx``: loss terms rtol 1e-6, gradients per leaf
  ||remat - plain|| / ||plain|| <= 1e-6, running statistics equal;
* bf16 (the train step's ``functional_call`` on bf16 casts of the fp32
  masters) for ``full`` and ``featup,concat,spx``, which together cover
  every component: the same bounds.  A recomputation that read the fp32
  masters instead of the casts would move the gradients by bf16's
  rounding, about 1e-2 relative.

Each component the spec names must run its forward twice in the step (once
more in the backward) and every other once, and the running statistics
must move once.  The spec parser agrees with the JAX package's
``_remat_components``, its error message included.
"""

import pytest
import torch

from semstereo_tpu_torch.config import ModelConfig, TrainConfig
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.models.semstereo import remat_components
from semstereo_tpu_torch.train import init_state, make_grads_fn
from tests._torch_threads import two_torch_threads  # noqa: F401

S = 32
MODEL = dict(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2))
# The modules of each component; "hourglass" is both hourglasses.
MODULES = {"backbone": ("feature",), "featup": ("feature_up",),
           "hourglass": ("hourglass_att", "hourglass"), "concat": ("concat_feature",),
           "spx": ("spx32_16", "spx16_8", "spx8_4", "spx4_2")}


def _step(dtype, remat):
    """(loss terms, gradients, buffers, forward calls per module) of one
    step's gradients from the seeded state."""
    cfg = TrainConfig(model=ModelConfig(**MODEL, remat=remat), compute_dtype=dtype)
    model = init_state(cfg, device="cpu").model
    calls = dict.fromkeys([name for names in MODULES.values() for name in names], 0)
    for name in calls:
        getattr(model, name).register_forward_pre_hook(
            lambda *_, name=name: calls.__setitem__(name, calls[name] + 1))
    batch = SyntheticStereoDataset(2, S, S, 16).batch(0, 2)
    aux, _, _ = make_grads_fn(cfg)(model, batch)
    return ({k: v.item() for k, v in aux.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()}, calls)


@pytest.fixture(scope="module")
def plain():
    return {dtype: _step(dtype, False) for dtype in ("float32", "bfloat16")}


@pytest.mark.parametrize("dtype,spec", [
    *(("float32", s) for s in ("full", "backbone", "featup", "hourglass", "concat", "spx")),
    ("bfloat16", "full"), ("bfloat16", "featup,concat,spx")])
def test_remat_step_equals_the_plain_step(plain, dtype, spec):
    aux0, grads0, bufs0, calls0 = plain[dtype]
    aux, grads, bufs, calls = _step(dtype, spec)
    again = {m for c in remat_components(spec) for m in MODULES[c]}
    for name, n in calls.items():
        assert n == calls0[name] * (2 if name in again else 1), (name, n, calls0[name])
    for k, v in aux0.items():
        assert aux[k] == pytest.approx(v, rel=1e-6), k
    for n, g in grads0.items():
        err = float((grads[n] - g).double().norm())
        assert err <= 1e-6 * max(float(g.double().norm()), 1e-12), (n, err)
    for n, b in bufs0.items():
        assert torch.equal(bufs[n], b), n


@pytest.mark.parametrize("spec", [False, None, "", "none", True, "full", "backbone",
                                  "featup", "featup,concat,spx", " hourglass , spx,",
                                  "backbone,featup,hourglass,concat,spx"])
def test_remat_spec_parses_as_jax_parses_it(spec):
    from semstereo_tpu.models.semstereo import _remat_components

    assert remat_components(spec) == _remat_components(spec)


@pytest.mark.parametrize("spec", ["bogus", "featup,neck"])
def test_remat_spec_refuses_what_jax_refuses(spec):
    from semstereo_tpu.models.semstereo import _remat_components

    with pytest.raises(AssertionError) as jax_error:
        _remat_components(spec)
    with pytest.raises(ValueError) as port_error:
        remat_components(spec)
    assert str(port_error.value) == str(jax_error.value)
