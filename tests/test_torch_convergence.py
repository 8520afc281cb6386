"""The port's training stack trains, on the CPU.

* ``test_loss_decreases``: the counterpart of the JAX package's
  ``test_loss_decreases`` (tests/test_train_integration.py).  Its tiny
  config (maxdisp 16, topk 4, attention windows (1, 2, 2), seg and LRSC
  losses, lr 1e-3) takes 8 steps of one synthetic 32x32 batch of 2 from the
  seeded fp32 initial state: every loss is finite and the last is below the
  first, as JAX holds it (measured on the CPU: 36.55 falling to 10.67).
* The convergence harness (``semstereo_tpu_torch.convergence``, the
  counterpart of ``benchmarks/convergence.py``): its data equal JAX's
  harness's once decoded; its log parser reads the port's ``cli.train`` log
  as JAX's parser does; a short ``--device cpu`` run of the overfit and the
  two-stage recipe writes a record with every ``pass_*`` key; a false
  ``pass_*`` makes it exit 1; the bf16-against-fp32 verdict holds the
  medians of the seeds' tails.  Its full runs (60 and 12 epochs, 200-step
  curves at five seeds) are for the card (``chip_smoke.py``'s bf16 curves
  and convergence phases).
"""

import contextlib
import importlib.util
import io
import json
import os
import tempfile

import numpy as np
import pytest

from semstereo_tpu_torch import convergence
from semstereo_tpu_torch.config import DataConfig, LossConfig, ModelConfig, OptimConfig, TrainConfig
from semstereo_tpu_torch.data import SyntheticStereoDataset, Us3dDataset
from semstereo_tpu_torch.train import init_state, make_train_step
from tests._torch_threads import two_torch_threads  # noqa: F401

TINY = TrainConfig(
    model=ModelConfig(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2)),
    data=DataConfig(batch_size=2),
    optim=OptimConfig(lr=1e-3),
    loss=LossConfig(use_seg=True, use_lrsc=True),
)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The harness's CPU run: the generated data cut to 2 train pairs and 1 test pair.
ROWS = dict(n_train=2, n_test=1)


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence", os.path.join(ROOT, "benchmarks", "convergence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_loss_decreases():
    state = init_state(TINY, device="cpu")
    step = make_train_step(TINY)
    batch = SyntheticStereoDataset(2, 32, 32, 16).batch(0, 2)
    losses = [float(step(state, batch)["loss"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_gen_dataset_decodes_as_the_jax_harness(tmp_path):
    """Every pair of both lists, read by the port's US3D loader, equals the
    JAX harness's pair of the same seed, and the lists name the same files."""
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    convergence.gen_dataset(mine, **ROWS)
    _jax_harness().gen_dataset(theirs, **ROWS)
    for name in ("train.txt", "test.txt"):
        with open(os.path.join(mine, name)) as f, open(os.path.join(theirs, name)) as g:
            assert f.read() == g.read()
        a, b = (Us3dDataset(root, os.path.join(root, name), False) for root in (mine, theirs))
        assert len(a) == ROWS["n_train" if name == "train.txt" else "n_test"]
        for i in range(len(a)):
            sa, sb = a.get(i, None), b.get(i, None)
            assert sorted(sa) == sorted(sb)
            for key, value in sa.items():
                if isinstance(value, np.ndarray):
                    np.testing.assert_array_equal(value, sb[key], err_msg=f"{name} {i} {key}")


def _in_this_process(kind, args, device):
    """``convergence.run_cli``, its child process's work
    (``convergence.child``) done in this process: a child process would
    spend seconds importing PyTorch.  ``chip_smoke.py``'s convergence phase
    runs the harness with its child processes."""
    with tempfile.TemporaryDirectory() as tmp:
        out, printed = os.path.join(tmp, "launches.json"), io.StringIO()
        with contextlib.redirect_stdout(printed):
            convergence.child([kind, out, *args, "--device", device])
        with open(out) as f:
            return printed.getvalue(), json.load(f)


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """``convergence.main`` on the CPU: the overfit (2 epochs) and the
    two-stage recipe (1 epoch a stage) on the generated data."""
    workdir = str(tmp_path_factory.mktemp("convergence"))
    gen, run_cli = convergence.gen_dataset, convergence.run_cli
    convergence.gen_dataset = lambda root: gen(root, **ROWS)
    convergence.run_cli = _in_this_process
    try:
        rc = convergence.main(["--device", "cpu", "--workdir", workdir, "--overfit-epochs", "2",
                               "--twostage-epochs", "1", "--only", "overfit",
                               "--only", "twostage"])
    finally:
        convergence.gen_dataset, convergence.run_cli = gen, run_cli
    with open(os.path.join(workdir, "convergence.json")) as f:
        return workdir, rc, json.load(f)["convergence"]


def test_harness_writes_every_pass_key(cpu_run):
    _, rc, conv = cpu_run
    assert rc == (0 if all(v for sec in conv.values() for k, v in sec.items()
                           if k.startswith("pass_")) else 1)
    assert {k for k in conv["overfit"] if k.startswith("pass_")} == {
        "pass_epe_lt_1px", "pass_miou_gt_0.95"}
    assert {k for k in conv["two_stage"] if k.startswith("pass_")} == {
        "pass_stage2_beats_stage1_epe", "pass_seg_loss_decreases", "pass_lrsc_loss_decreases",
        "pass_partial_restore_count", "pass_standalone_eval_matches"}
    ov, ts = conv["overfit"], conv["two_stage"]
    assert ov["steps"] == 2 * ROWS["n_train"] // 2 and np.isfinite(ov["final"]["EPE"])
    # the restore and the standalone evaluation hold on any number of epochs
    assert ts["pass_partial_restore_count"] and ts["partial_restore_tensors"] > 0
    assert ts["pass_standalone_eval_matches"]
    # the plain versions run on the CPU: no kernel launched
    assert set(ov["launches"].values()) == {0}


def test_parse_log_reads_as_the_jax_parser(cpu_run):
    """The port's parser and JAX's on a log of the port's ``cli.train``:
    the same steps and eval records, the port's also with each step's time."""
    workdir = cpu_run[0]
    with open(os.path.join(workdir, "stage1", "log.log")) as f:
        text = f.read()
    iters, evals = convergence.parse_log(text)
    jiters, jevals = _jax_harness().parse_log(text)
    assert len(iters) == ROWS["n_train"] // 2 and len(evals) == 1
    assert [{k: v for k, v in r.items() if k != "time"} for r in iters] == jiters
    assert all(r["time"] >= 0 for r in iters)
    assert evals == jevals and {"EPE", "D1", "mIoU"} <= set(evals[0])


def test_harness_exits_1_on_a_failed_check(tmp_path, monkeypatch):
    monkeypatch.setattr(convergence, "gen_dataset", lambda root: None)
    for ok in (True, False):
        monkeypatch.setattr(convergence, "overfit",
                            lambda *a, ok=ok: {"pass_epe_lt_1px": True, "pass_miou_gt_0.95": ok})
        assert convergence.main(["--device", "cpu", "--workdir", str(tmp_path),
                                 "--only", "overfit"]) == (0 if ok else 1)


def test_tail_verdict_holds_the_median_tails():
    """The bf16 bound over seeds: a plateau at one seed, in either dtype,
    leaves the ratio of the median tails in place; bf16 tails 15 % above
    fp32's at most seeds break it; a tail above FALL_TRACKS of its first
    loss fails the fall."""

    def curve(first, tail):
        return [first] * 190 + [tail] * 10

    fp32 = [curve(30.0, t) for t in (2.7, 2.6, 2.8, 6.0, 2.65)]
    bf16 = [curve(30.0, t) for t in (2.6, 6.5, 2.75, 2.7, 2.6)]
    v = convergence.tail_verdict(fp32, bf16)
    assert v["pass_bf16_tracks_fp32"] and v["pass_both_decrease"]
    assert v["median_tail_ratio_bf16_over_fp32"] == pytest.approx(2.7 / 2.7)
    v = convergence.tail_verdict(fp32, [curve(30.0, 1.15 * t) for t in (2.7, 2.6, 2.8, 2.7, 2.65)])
    assert not v["pass_bf16_tracks_fp32"]
    v = convergence.tail_verdict(fp32, [curve(30.0, 22.0), *bf16[1:]])
    assert not v["pass_both_decrease"]
