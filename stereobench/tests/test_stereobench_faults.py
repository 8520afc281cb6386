"""``correct`` comes out false when the timed path is broken underneath, and
true when it is not: each cell's run, the look for a card left out, on the
CPU at a tiny size with the program in fp32 (the cells' limits are set on
the card for bf16, which only widens them), once for each fault the cell
can have.  And the control (the reference in fp8 in the program's place)
comes out not correct."""

import pytest
import torch

from conftest import tiny_cell
from stereobench import cell as cells
from stereobench import control, judge, run

SEED = 2**31 + 77
EVAL = ["us3d_s2_eval_b1", "us3d_s2_eval_b4"]
TRAIN = ["us3d_s2_train_b4", "us3d_s1_train_b4"]


def _cell(name):
    return tiny_cell(name, batch=2 if name.endswith("b4") else None)


def _correct(name) -> bool:
    return run.execute(_cell(name), SEED, 0.5, trace=False, device="cpu")["correct"]


def _altered_answer(monkeypatch):
    """The first pair's disparity answer set to 0 where it is produced: the
    stage-2 regression's output, or in stage 1 the disparities of the
    attention's top-k planes."""
    import semstereo_tpu_torch.models.semstereo as sm

    regress, planes = sm.regression_topk, sm.topk_planes

    def zero_first(t):
        return torch.cat([torch.zeros_like(t[:1]), t[1:]])

    monkeypatch.setattr(sm, "regression_topk", lambda *a: zero_first(regress(*a)))

    def zeroed(*a, **k):
        prob, raw, samples = planes(*a, **k)
        return prob, raw, zero_first(samples)

    monkeypatch.setattr(sm, "topk_planes", zeroed)


def _half_batch_eval(monkeypatch):
    """The model runs on the first half of the batch and serves its outputs
    for the whole."""
    from semstereo_tpu_torch.models.semstereo import SemStereo

    forward = SemStereo.forward

    def half(self, left, right):
        n = left.shape[0]
        out = forward(self, left[:n // 2], right[:n // 2])
        rep = lambda t: t.repeat(2, *[1] * (t.dim() - 1))  # noqa: E731
        return {k: tuple(rep(t) for t in v) if isinstance(v, tuple) else rep(v)
                for k, v in out.items()}

    monkeypatch.setattr(SemStereo, "forward", half)


def _half_batch_train(monkeypatch):
    """The losses over the first half of the batch, their mean taken over it."""
    import semstereo_tpu_torch.train.steps as steps

    assemble = steps.assemble_train_loss

    def half(cfg, out, batch, rows=None):
        n = batch["left"].shape[0] // 2
        cut = lambda t: t[:n]  # noqa: E731
        out = {k: tuple(map(cut, v)) if isinstance(v, tuple) else cut(v) for k, v in out.items()}
        total, aux, mask = assemble(cfg, out, {k: cut(v) for k, v in batch.items()}, rows)
        return total, aux, torch.cat([mask, mask])

    monkeypatch.setattr(steps, "assemble_train_loss", half)


def test_an_unchanged_state_reads_one():
    """The median leaf's change and the gradient's numbers read 1 when the
    program's state is left unchanged (the reference's change and first
    gradient of each leaf, module or rank at or above the median are
    missed whole: Adam holds no moment), whatever the run."""
    from stereobench import judge

    leaves = [f"m{i % 3}.w{i}" for i in range(9)]
    want = {"loss": [1.0], "terms": {}, "grad": {k: 1.0 + i for i, k in enumerate(leaves)},
            "change": {k: torch.full((4,), 0.5 + i) for i, k in enumerate(leaves)},
            "rank": {k: 1 + i % 2 for i, k in enumerate(leaves)},
            "kept": {k: torch.tensor([True, True, False, True]) for k in leaves}}
    got = dict(want, change={k: torch.zeros(4) for k in leaves}, grad={k: 0.0 for k in leaves})
    r = judge.train_numbers(got, want)
    assert r["change_leaf_median"] == r["grad_leaf_median"] == r["change_leaf_kept"] == 1.0
    assert r["grad_module_median"] == r["grad_rank"] == 1.0


def _plant(monkeypatch, module, name, fn):
    """``module.name`` replaced by ``fn``, which takes over the launch counts
    the kernel's wrapper keeps on its module-level name."""
    fn.launches = fn.planes = fn.rows = 0
    monkeypatch.setattr(module, name, fn)


def _dw_doubled(monkeypatch):
    """K3's dw returns twice the weight gradient."""
    import semstereo_tpu_torch.ops.conv3d as c3

    dw = c3.conv3d_weight_grad
    _plant(monkeypatch, c3, "conv3d_weight_grad", lambda x, gy, stride: 2 * dw(x, gy, stride))


def _k4_doubled(monkeypatch):
    """K4 returns twice the gradients of the features."""
    import semstereo_tpu_torch.ops.cost_volume as cv

    bwd = cv.gwc_volume_norm_bwd
    _plant(monkeypatch, cv, "gwc_volume_norm_bwd", lambda *a: tuple(2 * g for g in bwd(*a)))


def _leaf_unmoved(monkeypatch):
    """The optimizer's step leaves the model's largest parameter as it was."""
    step = torch.optim.Adam.step

    def skip_largest(self, closure=None):
        p = max(self.param_groups[0]["params"], key=torch.Tensor.numel)
        before = p.detach().clone()
        out = step(self, closure)
        with torch.no_grad():
            p.copy_(before)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", skip_largest)


def _unchanged_state(monkeypatch):
    """The optimizer's step leaves the parameters as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


@pytest.mark.parametrize("name", EVAL + TRAIN)
def test_a_sound_run_is_correct(name):
    assert _correct(name)


FAULTS = [(n, "altered answer", _altered_answer) for n in EVAL]
FAULTS += [("us3d_s2_eval_b4", "half the batch", _half_batch_eval)]
FAULTS += [(n, "half the batch", _half_batch_train) for n in TRAIN]
FAULTS += [(n, "unchanged state", _unchanged_state) for n in TRAIN]
FAULTS += [(n, "a leaf unmoved", _leaf_unmoved) for n in TRAIN]
FAULTS += [("us3d_s1_train_b4", "K3 dw doubled", _dw_doubled),
           ("us3d_s1_train_b4", "K4 doubled", _k4_doubled)]


@pytest.mark.parametrize("name,fault,plant", FAULTS, ids=[f"{n}-{f}" for n, f, _ in FAULTS])
def test_a_fault_is_not_correct(monkeypatch, name, fault, plant):
    plant(monkeypatch)
    assert not _correct(name)


@pytest.mark.parametrize("name", EVAL + TRAIN)
def test_the_control_is_not_correct(name):
    cell = _cell(name)
    correct, _ = judge.decide(control.readings(cell, SEED, device="cpu"), cell.limits)
    assert not correct


def test_the_control_on_the_card(card):
    """The control at the cell's own size on the card (``control.py``)."""
    cell = cells.load("us3d_s2_eval_b1")
    correct, _ = judge.decide(control.readings(cell, SEED), cell.limits)
    assert not correct
