"""Checkpoints of the port, on the CPU.

* Save then restore gives back bitwise every weight, BN running statistic,
  Adam moment and step count, and ``epoch`` + 1; ``latest_epoch`` skips a
  partly written file.
* A run resumed from a checkpoint takes the same next step, bitwise, as
  the run that never stopped.
* A stage-1 checkpoint of the port, partially restored into a stage-2
  model, loads the same leaves, by count and by value, as the JAX
  package's ``merge_partial_params`` on the same numpy weights (the port's
  tensors compared in the JAX tree through ``convert_semstereo_state_dict``).

Tiny config: maxdisp 16, attention windows (1,2,2), 32x32, batch 2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semstereo_tpu.config import ModelConfig as JModelConfig
from semstereo_tpu.config import TrainConfig as JTrainConfig
from semstereo_tpu.train.state import build_model as jbuild_model
from semstereo_tpu.train.state import merge_partial_params as jmerge_partial_params
from semstereo_tpu.utils.torch_convert import convert_semstereo_state_dict
from semstereo_tpu_torch.config import ModelConfig, TrainConfig
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.models import SemStereo
from semstereo_tpu_torch.train import (
    TrainState,
    build_optimizer,
    init_state,
    make_train_step,
    set_learning_rate,
)
from semstereo_tpu_torch.train import checkpoint as ckpt
from tests._torch_threads import two_torch_threads  # noqa: F401

H = W = 32
TINY = dict(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2))
CFG = TrainConfig(model=ModelConfig(**TINY))


def _batch():
    return SyntheticStereoDataset(2, H, W, 16).batch(0, 2)


def _assert_state_equal(a: TrainState, b: TrainState):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys() and len(oa["state"]) == len(sa) - sum(
        1 for k in sa if k.endswith(("running_mean", "running_var")))
    for i, s in oa["state"].items():
        assert s.keys() == ob["state"][i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k, v in s.items():
            assert v.device == ob["state"][i][k].device and torch.equal(v, ob["state"][i][k])


def test_save_then_restore_is_bitwise(tmp_path):
    state = init_state(CFG, device="cpu")
    train_step = make_train_step(CFG)
    set_learning_rate(state, CFG, 12)
    train_step(state, _batch())
    logdir = str(tmp_path / "run")
    path = ckpt.save_checkpoint(logdir, state, epoch=3)
    assert os.path.basename(path) == "checkpoint_000003.pt"
    # a partly written later checkpoint is not a checkpoint
    open(os.path.join(logdir, "checkpoint_000009.pt.123.tmp"), "wb").close()
    assert ckpt.latest_epoch(logdir) == 3
    assert ckpt.latest_epoch(str(tmp_path / "none")) is None
    blank = init_state(CFG.replace(seed=99), device="cpu")
    restored = ckpt.restore_checkpoint(logdir, blank)
    assert restored.epoch == 4
    assert restored.optimizer.param_groups[0]["lr"] == 5e-4
    _assert_state_equal(restored, state)
    # Adam keeps its step count on the CPU as a float tensor
    step = restored.optimizer.state_dict()["state"][0]["step"]
    assert step.device.type == "cpu" and float(step) == 1.0
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), blank)


def test_resume_then_one_step_equals_the_uninterrupted_run(tmp_path):
    train_step = make_train_step(CFG)
    batches = [SyntheticStereoDataset(4, H, W, 16).batch(i, 2) for i in (0, 2)]
    run = init_state(CFG, device="cpu")
    train_step(run, batches[0])
    ckpt.save_checkpoint(str(tmp_path), run, epoch=0)
    want = train_step(run, batches[1])

    resumed = ckpt.restore_checkpoint(str(tmp_path), init_state(CFG.replace(seed=5), device="cpu"))
    got = train_step(resumed, batches[1])
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    _assert_state_equal(resumed, run)


def _numpy_trees(att_weights_only: bool, seed: int):
    """Random flax trees of the tiny model, shaped by ``eval_shape``."""
    jcfg = JTrainConfig(model=JModelConfig(**TINY, att_weights_only=att_weights_only))
    jmodel = jbuild_model(jcfg)
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy,
                                                 train=False))
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes)
    return v["params"], v["batch_stats"]


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_partial_restore_loads_the_leaves_jax_loads(tmp_path):
    p1, s1 = _numpy_trees(True, seed=1)
    p2, s2 = _numpy_trees(False, seed=2)
    jparams, n1 = jmerge_partial_params(p2, p1)
    jstats, n2 = jmerge_partial_params(s2, s1)

    stage1 = SemStereo(**TINY, att_weights_only=True)
    load_flax_variables(stage1, p1, s1)
    cfg1 = CFG.replace(model=ModelConfig(**TINY, att_weights_only=True))
    ckpt.save_checkpoint(
        str(tmp_path), TrainState(stage1, build_optimizer(cfg1, stage1.parameters())), epoch=47)
    stage2 = SemStereo(**TINY)
    load_flax_variables(stage2, p2, s2)
    before = {k: v.clone() for k, v in stage2.state_dict().items()}
    state, n = ckpt.restore_partial(str(tmp_path), TrainState(stage2, build_optimizer(
        CFG, stage2.parameters())))
    assert state.epoch == 0
    assert 0 < n < len(before)
    assert n == n1 + n2
    params, stats, unused = convert_semstereo_state_dict(state.model.state_dict())
    assert unused == []
    for got, want in ((_flat(params), _flat(jparams)), (_flat(stats), _flat(jstats))):
        assert set(got) == set(want)
        for path, w_ in want.items():
            assert np.array_equal(got[path], w_), path
    # stage-2-only leaves keep their values; shared ones take stage 1's
    after, s1_sd = state.model.state_dict(), stage1.state_dict()
    stage2_only = [k for k in before if k not in s1_sd]
    assert any(k.startswith("hourglass.") for k in stage2_only)
    for k in before:
        assert torch.equal(after[k], s1_sd[k] if k in s1_sd else before[k]), k
