"""The plain reference against the port at a tiny configuration on the CPU,
in fp32, from the benchmark's weights: the same state-dict keys and
shapes, the same eval outputs, and the same first train step (the
reference following the port's choices of planes, as in a run)."""

import pytest
import torch

from conftest import tiny_cell
from stereobench import inputs, judge, reference, weights
from stereobench.choices import Choices
from stereobench.drivers import train as train_driver


def _port_model(cell):
    from semstereo_tpu_torch.config import ModelConfig
    from semstereo_tpu_torch.models import build_model

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.model.items()}
    return build_model(ModelConfig(**fields), device="cpu")


@pytest.mark.parametrize("stage1", [False, True])
def test_state_dicts_share_keys_and_shapes(stage1):
    cell = tiny_cell("us3d_s1_train_b4" if stage1 else "us3d_s2_eval_b1")
    port = {k: v.shape for k, v in _port_model(cell).state_dict().items()}
    ref = {k: v.shape for k, v in reference.build(cell.model).state_dict().items()}
    assert port == ref


@pytest.mark.parametrize("name", ["us3d_s2_eval_b1", "us3d_s1_train_b4"])
def test_eval_outputs_agree(name):
    cell = tiny_cell(name)
    sd = weights.make_state_dict(cell.model, 11, "cpu")
    port = _port_model(cell)
    port.load_state_dict(sd)
    ref = reference.build(cell.model).eval()
    ref.load_state_dict(sd)
    rows = inputs.pairs(dict(cell.traffic, batch=2), 6, 11, "cpu")[0]
    got = port(rows["left"], rows["right"])
    with torch.no_grad():
        want = ref(rows["left"], rows["right"])
    for j in range(2):
        r = judge.pair_numbers(got["disp"][0][j], got["label_l"][j], want["disp"][0][j],
                               want["label_l"][j])
        assert r["label_rel"] < 1e-5 and r["disp_med"] < 1e-3
    assert torch.allclose(got["label_r"], want["label_r"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["us3d_s2_train_b4", "us3d_s1_train_b4"])
def test_first_train_step_agrees(name):
    from semstereo_tpu_torch.config import TRAIN_PRESETS, ModelConfig
    from semstereo_tpu_torch.train import init_state, make_train_step

    cell = tiny_cell(name, batch=2)
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.model.items()}
    cfg = TRAIN_PRESETS[cell.config["preset"]].replace(model=ModelConfig(**fields))
    assert cfg.optim.lr == cell.config["optimizer"]["lr"]
    assert tuple(cfg.optim.betas) == tuple(cell.config["optimizer"]["betas"])
    sd = weights.make_state_dict(cell.model, 12, "cpu")
    state = init_state(cfg, device="cpu")
    state.model.load_state_dict(sd)
    batch = inputs.pairs(cell.traffic, 6, 12, "cpu")[0]
    choices = Choices()
    choices.install()
    try:
        loss = make_train_step(cfg)(state, batch)["loss"].item()
    finally:
        choices.uninstall()
    want = train_driver.reference_steps(cell, sd, [batch], "cpu", taken=choices.taken)
    assert all(v <= 0 for v in want["margins"].values())  # fp32 on both sides: the same choices
    assert abs(loss - want["loss"][0]) <= 1e-4 * abs(want["loss"][0])
    # fp32 on both sides, differing in the order of their sums: a leaf whose
    # gradient is a sum with much cancellation (a normalisation's scale or
    # a bias over every token) keeps a few per cent of it, as chip_smoke's
    # TRAIN_BOUNDS allow a card step against the CPU's
    got = {n: (state.optimizer.state[p]["exp_avg"] / 0.1).norm().item()
           for n, p in state.model.named_parameters()}
    moved = {n: p.detach() - sd[n] for n, p in state.model.named_parameters()}
    r = judge.train_numbers(dict(want, grad=got, change=moved, loss=[loss]), want)
    assert r["grad_leaf"] <= 0.05 and r["grad_leaf_median"] <= 0.01
    # Adam's first step moves every element by about lr, its sign that of a
    # gradient element: the elements near nought flip with the rounding
    assert r["change_leaf_median"] <= 0.05
