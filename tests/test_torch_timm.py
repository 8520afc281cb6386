"""The pretrained-backbone loader (``utils/timm_convert.py``) against the
JAX package's converter, on a timm-named state_dict of
``tests/_reference_oracle.FakeTimmMobileViTv2`` with randomised BN affine
and statistics (a real ``mobilevitv2_100`` checkpoint has the same keys and
shapes; none is in reach here).

* The JAX path, ``convert_state_dict`` merged over the JAX model's
  ``feature`` tree and loaded into the port by ``load_flax_variables``, and
  the port's ``load_and_merge`` give equal tensors, exactly (the layouts
  are transposes), for every backbone tensor and the rest of the model.
* A missing key or a tensor of the wrong shape raises, naming it;
  ``require_complete=False`` loads what matches and counts as JAX counts.
* ``init_state`` with ``ModelConfig.pretrained_backbone`` loads the file
  and prints the count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semstereo_tpu.train.state import build_model as jbuild_model
from semstereo_tpu.train.state import merge_partial_params as jmerge
from semstereo_tpu.utils import timm_convert as jtimm
from semstereo_tpu import config as jconfig
from semstereo_tpu_torch.config import ModelConfig, TrainConfig
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.models import SemStereo
from semstereo_tpu_torch.train import init_state
from semstereo_tpu_torch.utils.timm_convert import load_and_merge
from tests._reference_oracle import FakeTimmMobileViTv2
from tests._torch_threads import two_torch_threads  # noqa: F401

MODEL = dict(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2))


def _timm_state_dict():
    """timm checkpoint naming (``stages.i.blocks.j``) of the oracle's
    features-only modules (``stages_i.j``), with randomised BN and GN."""
    torch.manual_seed(0)
    model = FakeTimmMobileViTv2()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                m.weight.mul_(1 + 0.2 * torch.rand(m.weight.shape, generator=gen))
                m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=gen))
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.add_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.mul_(1 + 0.2 * torch.rand(m.running_var.shape, generator=gen))
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("stages_"):
            stage, rest = k[len("stages_"):].split(".", 1)
            block, tail = rest.split(".", 1)
            k = f"stages.{stage}.blocks.{block}.{tail}"
        sd[k] = v.clone()
    return sd


@pytest.fixture(scope="module")
def timm(tmp_path_factory):
    sd = _timm_state_dict()
    path = tmp_path_factory.mktemp("timm") / "mobilevitv2_100.pth"
    torch.save(sd, path)
    return sd, str(path)


@pytest.fixture(scope="module")
def variables():
    """Numpy variables of the JAX model (the tiny config)."""
    jmodel = jbuild_model(jconfig.TrainConfig(model=jconfig.ModelConfig(**MODEL)))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy,
                                                 train=False))
    rng = np.random.default_rng(3)
    v = jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32), shapes)
    stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, v["batch_stats"])
    return v["params"], stats


def _port(params, stats):
    model = SemStereo(**MODEL)
    load_flax_variables(model, params, stats)
    return model


def test_loader_equals_the_jax_converter(timm, variables):
    sd, path = timm
    params, stats = variables
    conv_p, conv_s = jtimm.convert_state_dict({k: v.numpy() for k, v in sd.items()})
    feat_p, n_p = jmerge(params["feature"], conv_p)
    feat_s, n_s = jmerge(stats["feature"], conv_s)
    want = _port(dict(params, feature=feat_p), dict(stats, feature=feat_s)).state_dict()
    model = _port(params, stats)
    n = load_and_merge(path, model)
    assert n == n_p + n_s == len(model.feature.state_dict())
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # every backbone tensor came from the file: none kept its fresh value
    fresh = _port(params, stats).state_dict()
    assert all(not torch.equal(got[k], fresh[k]) for k in got if k.startswith("feature."))


@pytest.mark.parametrize("broken", ["missing", "shape"])
def test_loader_refuses_an_incomplete_checkpoint(timm, variables, tmp_path, broken):
    sd, _ = timm
    sd = dict(sd)
    key = "stages.4.blocks.1.transformer.2.mlp.fc1.weight"
    if broken == "missing":
        del sd[key]
    else:
        sd[key] = sd[key][:-1]
    path = tmp_path / "broken.pth"
    torch.save(sd, path)
    model = _port(*variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="feature.block4.1.transformer.2.mlp.fc1.weight"):
        load_and_merge(str(path), model)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_partial_load_counts_as_jax_counts(timm, variables, tmp_path):
    sd, _ = timm
    partial = {k: v for k, v in sd.items() if not k.startswith("stages.4")}
    path = tmp_path / "partial.pth"
    torch.save(partial, path)
    params, stats = variables
    with pytest.raises(ValueError, match="stage4"):
        jtimm.load_and_merge(str(path), params["feature"], stats["feature"])
    _, _, n_jax = jtimm.load_and_merge(str(path), params["feature"], stats["feature"],
                                       require_complete=False)
    model = _port(params, stats)
    with pytest.raises(ValueError, match="feature.block4"):
        load_and_merge(str(path), model)
    n = load_and_merge(str(path), model, require_complete=False)
    assert n == n_jax and 0 < n < len(model.feature.state_dict())
    assert torch.equal(model.feature.block3[1].norm.weight,
                       partial["stages.3.blocks.1.norm.weight"])


def test_init_state_loads_the_pretrained_backbone(timm, capsys):
    sd, path = timm
    cfg = TrainConfig(model=ModelConfig(**MODEL, pretrained_backbone=path))
    model = init_state(cfg, device="cpu").model
    n = len(model.feature.state_dict())
    assert f"loaded pretrained backbone: {n} leaves from {path}" in capsys.readouterr().out
    assert torch.equal(model.feature.conv_stem.conv.weight, sd["stem.conv.weight"])
    assert torch.equal(model.feature.block2[1].transformer[1].attn.qkv_proj.bias,
                       sd["stages.2.blocks.1.transformer.1.attn.qkv_proj.bias"])
    assert torch.equal(model.feature.block4[0].conv2_kxk.bn.running_var,
                       sd["stages.4.blocks.0.conv2_kxk.bn.running_var"])
    assert model.training
