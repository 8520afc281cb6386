"""Data parallelism of the port on the CPU: two gloo processes against one
process on the same global batch.

The JAX package runs its train step on one global array, so its losses,
metrics and BatchNorm statistics are those of the global batch.  Two
processes of the port, each with its half of the rows, must give the
one-process result:

* one fp32 step (tiny model, 32x32, global batch 2): the loss terms and
  metrics, the BN running statistics, every gradient and the
  Adam-updated parameters; and again with ``grad_clip`` and ``grad_accum``
  (global batch 4, two microbatches per process);
* a ``Trainer`` epoch through ``cli.train --data-parallel 2`` on a
  US3D-format file list of 5 train rows at global batch 2 (an odd list:
  without the loader's cut to whole global batches, process 0 would take a
  third step alone and hang in its collectives), a checkpoint, then its
  eval epoch over 3 rows at global test batch 2, where the second process
  runs an alignment-only step, against the one-process CLI run, with the
  confusion matrix over the list and with ``eval_seg_per_batch``;
* ``all_reduce_sum_tree``, the eval's one host-side reduce, over two
  processes against the JAX package's function on the same arrays.

Every /4 plane stays in the top-k (``topk`` = ``refine_topk`` = 8), as in
tests/test_torch_train_model.py, so no hard choice of a plane sits on the
gradient's path.  The two sides differ by summation order only (the global
BN statistics are reduced in two passes, the losses' numerators per
process), but 40-odd train-mode BatchNorms over few rows grow that rounding
from 1e-7 at the stem to 1e-5 at the backbone's last stage (each
activation's relative difference, measured), enough to flip a few ReLUs,
which moves whole conv-weight gradients.  So the bounds are the measured
level with a margin (measured on the CPU: plain / clip_accum):

* loss terms and metrics rtol 1e-5 (2.6e-6 worst), D1 and Thres1-3 also
  one pixel's share (a pixel at a threshold);
* running statistics: each mean within 1e-5 of its channel's running
  standard deviation (1.7e-6 worst), each variance rtol 2e-5 (8.2e-6);
* gradients: the whole gradient ||2 - 1|| / ||1|| <= 0.02 (0.0081 /
  0.0099), each leaf <= 0.1 (0.046 / 0.032, in the stage-2 hourglass) for
  the leaves above 1e-6 of the whole gradient's norm, and the others
  (conv biases in front of a BatchNorm, true gradient 0) within 1e-7 of
  the whole norm (4e-9);
* the parameters after Adam, whose first step is lr * g / (|g| + 1e-8):
  within 1e-6 (1.2e-7) of one process wherever the two gradients agree in
  sign and are both at least 1e-4, where that step is lr * sign(g) to
  within lr * 1e-4 of its size; elsewhere within Adam's step, 2 lr.

Eval results rtol 1e-5 (the padded rows' dice term sees other images,
~1e-8).

Each process is a subprocess with its own timeout; the worker function is
``_worker`` below, run with ``RANK`` and ``WORLD_SIZE`` set as ``torchrun``
sets them.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from semstereo_tpu_torch.cli import evaluate as cli_evaluate
from semstereo_tpu_torch.cli import train as cli_train
from semstereo_tpu_torch.config import ModelConfig, OptimConfig, ParallelConfig, TrainConfig
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.parallel import all_reduce_sum_tree, check_parallel, check_space_rows
from semstereo_tpu_torch.train import init_state, make_train_step
from tests._torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64
MODEL = dict(maxdisp=16, topk=8, refine_topk=8, att_window1=(1, 2, 2), att_window2=(1, 2, 2))
TINY_FLAGS = ["--maxdisp", "16", "--topk", "8", "--att-window1", "1,2,2",
              "--att-window2", "1,2,2"]
CFGS = {
    "plain": TrainConfig(model=ModelConfig(**MODEL)),
    "clip_accum": TrainConfig(model=ModelConfig(**MODEL),
                              optim=OptimConfig(grad_clip=0.5, grad_accum=2)),
}
GLOBAL_BATCH = {"plain": 2, "clip_accum": 4}
LR = OptimConfig().lr
# One pixel's share of an image: a pixel whose error sits at a threshold of
# D1 or Thres1-3 can fall on either side.
PIXEL_SHARE = 1.0 / (S * S)
EVAL_FLAGS = ["--preset", "us3d_stage2", *TINY_FLAGS, "--batch-size", "2", "--device", "cpu"]
TRAIN_ROWS, TEST_ROWS = 5, 3
TIMEOUT = 240


def _step_results(cfg, batch):
    """(scalars, buffers, grads, params) of one train step from the seeded
    initial state on ``batch``."""
    state = init_state(cfg, device="cpu")
    scalars = {k: v.item() for k, v in make_train_step(cfg)(state, batch).items()}
    model = state.model
    return (scalars, {n: b.clone() for n, b in model.named_buffers()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def _rows(n, rank, world):
    """This process's rows of a global batch of ``n``: the loader's
    round-robin shard."""
    return {k: v[rank::world] for k, v in SyntheticStereoDataset(n, S, S, 16).batch(0, n).items()}


def _sum_tree_input(rank):
    """A tree of the shapes the eval reduces (a confusion matrix, a scalar),
    with values that differ per process."""
    rng = np.random.default_rng(rank)
    return (rng.integers(0, 9, (5, 5)).astype(np.float64), rng.uniform(), rng.uniform(size=3))


def _worker():
    """One process of the two: the steps, the CLI epoch and the meters'
    reduce, each result saved to ``$OUT_DIR/rank<r>.pt``."""
    from semstereo_tpu_torch import parallel

    torch.set_num_threads(2)
    parallel.init_process_group("cpu")
    rank, world = parallel.process_index(), parallel.process_count()
    out = {}
    for name, cfg in CFGS.items():
        out[name] = _step_results(cfg, _rows(GLOBAL_BATCH[name], rank, world))
    out["sum_tree"] = all_reduce_sum_tree(_sum_tree_input(rank))
    argv = [*sys.argv[1:], "--data-parallel", "2"]
    trainer = cli_train.main(argv)  # joins no group: this process is in one already
    out["eval"] = trainer.history[-1]["eval"]
    out["steps"] = len(trainer.history[-1]["step_s"])
    out["logdir"] = sorted(os.listdir(trainer.cfg.logdir))
    trainer.cfg = dataclasses.replace(trainer.cfg, eval_seg_per_batch=True)
    out["eval_per_batch"] = trainer.evaluate()
    torch.save(out, os.path.join(os.environ["OUT_DIR"], f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _write_us3d(root, n):
    """A US3D-format list of ``n`` rows at S x S (PNG views, float-TIFF
    disparity, PNG labels)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(5)
    rows = []
    for i in range(n):
        right = rng.integers(0, 255, (S, S, 3)).astype(np.uint8)
        d = int(rng.integers(-6, 7))
        Image.fromarray(np.roll(right, d, axis=1)).save(f"{root}/l{i}.png")
        Image.fromarray(right).save(f"{root}/r{i}.png")
        disp = (d + rng.uniform(-0.5, 0.5, (S, S))).astype(np.float32)
        Image.fromarray(disp, mode="F").save(f"{root}/d{i}.tif")
        Image.fromarray(rng.integers(0, 6, (S, S)).astype(np.uint8)).save(f"{root}/s{i}.png")
        rows.append(f"l{i}.png r{i}.png d{i}.tif s{i}.png")
    return rows


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-process results (one pair of subprocesses for every case)
    and the CLI arguments and data they ran on."""
    tmp = tmp_path_factory.mktemp("dp")
    root = str(tmp / "data")
    rows = _write_us3d(root, TRAIN_ROWS + TEST_ROWS)
    for name, part in (("train", rows[:TRAIN_ROWS]), ("test", rows[TRAIN_ROWS:])):
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    argv = ["--preset", "us3d_stage2", "--datapath", root, "--trainlist", f"{root}/train.txt",
            "--testlist", f"{root}/test.txt", *TINY_FLAGS, "--batch-size", "2",
            "--test-batch-size", "2", "--epochs", "1", "--save-freq", "1", "--num-workers", "1",
            "--device", "cpu"]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OUT_DIR=str(tmp), PYTHONPATH=ROOT)
    code = "from tests.test_torch_parallel import _worker; _worker()"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *argv, "--logdir", str(tmp / "dp_run")], cwd=ROOT,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return dict(ranks=[torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)],
                argv=argv, tmp=tmp, root=root)


def _assert_grads_agree(grads, got):
    """The bounds of the module docstring on the gradients."""
    total = sum(float(g.double().square().sum()) for g in grads.values()) ** 0.5
    whole = sum(float((got[n] - g).double().square().sum()) for n, g in grads.items()) ** 0.5
    assert whole <= 0.02 * total, whole / total
    leaf_errors = {}
    for n, want in grads.items():
        err, size = float((got[n] - want).double().norm()), float(want.double().norm())
        if size > 1e-6 * total:
            leaf_errors[n] = err / size
        else:  # a true gradient of 0: rounding noise on both sides
            assert err <= 1e-7 * total, (n, err / total)
    assert len(leaf_errors) > 0.9 * len(grads)
    worst = max(leaf_errors, key=leaf_errors.get)
    assert leaf_errors[worst] <= 0.1, (worst, leaf_errors[worst])


def _assert_adam_agrees(params, got, grads, got_grads):
    """The parameters after the first Adam step, lr * g / (|g| + 1e-8): held
    to 1e-6 where the two gradients agree in sign and are both at least
    1e-4, else to Adam's step on each side."""
    held = 0
    for n, want in params.items():
        g1, g2 = grads[n], got_grads[n]
        sure = (torch.sign(g1) == torch.sign(g2)) & (g1.abs() >= 1e-4) & (g2.abs() >= 1e-4)
        diff = (got[n] - want).abs()
        assert diff.max() <= 2 * LR + 1e-6, n
        if sure.any():
            assert diff[sure].max() <= 1e-6, (n, float(diff[sure].max()))
        held += int(sure.sum())
    assert held >= 1e5, held


@pytest.mark.parametrize("case", sorted(CFGS))
def test_two_processes_take_the_one_process_step(runs, case):
    cfg = CFGS[case]
    scalars, buffers, grads, params = _step_results(cfg, _rows(GLOBAL_BATCH[case], 0, 1))
    (s2, b2, g2, p2), (_, _, g2b, p2b) = (runs["ranks"][r][case] for r in (0, 1))
    assert set(s2) == set(scalars)
    for k, want in scalars.items():
        tol = PIXEL_SHARE if k in ("D1", "Thres1", "Thres2", "Thres3") else 0.0
        np.testing.assert_allclose(s2[k], want, rtol=1e-5, atol=tol + 1e-7, err_msg=k)
    for n, want in buffers.items():
        if n.endswith("running_mean"):
            std = buffers[n[:-len("mean")] + "var"].sqrt()
            assert ((b2[n] - want).abs() <= 1e-5 * std).all(), n
        elif n.endswith("running_var"):
            torch.testing.assert_close(b2[n], want, rtol=2e-5, atol=0.0, msg=n)
        else:
            assert torch.equal(b2[n], want), n
    # both processes hold the summed gradients and the same update of them
    for n in params:
        assert torch.equal(g2[n], g2b[n]) and torch.equal(p2[n], p2b[n]), n
    _assert_grads_agree(grads, g2)
    _assert_adam_agrees(params, p2, grads, g2)
    if case == "clip_accum":  # the clip acted on the summed gradients
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in g2.values()]))
        assert abs(float(norm) - cfg.optim.grad_clip) < 1e-5, float(norm)


def _assert_eval_agrees(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        tol = PIXEL_SHARE if k in ("D1", "Thres1", "Thres2", "Thres3") else 0.0
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=tol + 1e-7, err_msg=k)


def test_two_process_cli_epoch_equals_one_process(runs, tmp_path, capsys):
    """``cli.train --data-parallel 2`` on the odd train list: both processes
    take the one process's 2 steps with its losses, process 0 writes the
    checkpoint once, and the eval epoch's results, on both processes, equal
    the one-process evaluation of that checkpoint (the second process's
    shard holds 1 of the 3 rows, so its second step is alignment-only)."""
    dp_run = str(runs["tmp"] / "dp_run")
    want = cli_evaluate.main([*EVAL_FLAGS, "--datapath", runs["root"], "--testlist",
                              f"{runs['root']}/test.txt", "--loadckpt", dp_run])
    for rank in (0, 1):
        assert runs["ranks"][rank]["steps"] == TRAIN_ROWS // 2
        _assert_eval_agrees(runs["ranks"][rank]["eval"], want)
    assert runs["ranks"][0]["logdir"] == ["checkpoint_000000.pt", "log.log"]
    capsys.readouterr()
    cli_train.main([*runs["argv"], "--logdir", str(tmp_path / "one")])
    # each step's losses on the same samples: the first from the same
    # weights, as printed to 3 decimals; the second after an Adam step that
    # moved the elements whose gradient sign the rounding flipped (0.6%) by
    # 2 lr, rtol 0.02 (0.0084 measured)
    one_log, dp_log = capsys.readouterr().out, open(os.path.join(dp_run, "log.log")).read()
    for it, (rtol, atol) in enumerate([(0.0, 1.5e-3), (0.02, 0.0)]):
        prefix = f"Epoch 0/1, Iter {it}/{TRAIN_ROWS // 2}"
        np.testing.assert_allclose(_loss_terms(dp_log, prefix), _loss_terms(one_log, prefix),
                                   rtol=rtol, atol=atol)
    assert f"Iter {TRAIN_ROWS // 2}/" not in dp_log + one_log
    sd2 = torch.load(os.path.join(dp_run, "checkpoint_000000.pt"), weights_only=True)
    sd1 = torch.load(tmp_path / "one" / "checkpoint_000000.pt", weights_only=True)
    assert sd2["epoch"] == sd1["epoch"] == 0 and sd2["model"].keys() == sd1["model"].keys()
    diffs = []
    for n, p in sd1["model"].items():
        if "running_" not in n:
            diffs.append((sd2["model"][n] - p).abs().ravel())
    diffs = torch.cat(diffs) / LR
    # each of the 2 Adam steps of each run moves an element by at most
    # 1.0014 lr (the first lr, the second lr * |m^| / sqrt(v^)); the second
    # step's lr * m^ / sqrt(v^) follows the ratio of the two steps' gradient
    # elements, so the runs part by 0.099 lr at the median (measured)
    assert float(diffs.max()) <= 4.003, float(diffs.max())
    assert float(diffs.median()) <= 0.25, float(diffs.median())


def test_two_process_per_batch_eval_equals_one_process(runs):
    """The eval with ``eval_seg_per_batch`` (each step's confusion matrix
    summed over the processes, then metered) on both processes against the
    one-process evaluation of the same checkpoint."""
    want = cli_evaluate.main([*EVAL_FLAGS, "--datapath", runs["root"], "--testlist",
                              f"{runs['root']}/test.txt", "--loadckpt",
                              str(runs["tmp"] / "dp_run"), "--eval-seg-per-batch"])
    for rank in (0, 1):
        _assert_eval_agrees(runs["ranks"][rank]["eval_per_batch"], want)


def _loss_terms(text, prefix):
    (line,) = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    return [float(part.split(" = ")[1]) for part in line.split(", ")[2:-1]]


def test_sum_tree_matches_jax(runs, monkeypatch):
    """The port's ``all_reduce_sum_tree`` over the two processes against
    the JAX package's fed the same two processes' arrays."""
    import semstereo_tpu.parallel.mesh as jmesh
    from jax.experimental import multihost_utils

    trees = [_sum_tree_input(r) for r in (0, 1)]
    monkeypatch.setattr(jmesh.jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda tree: tuple(np.stack([np.asarray(t[i]) for t in trees])
                                           for i in range(len(tree))))
    want = jmesh.all_reduce_sum_tree(trees[0])
    for rank in (0, 1):
        got = runs["ranks"][rank]["sum_tree"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("parallel,world", [
    (ParallelConfig(data=2), 1), (ParallelConfig(data=1), 2), (ParallelConfig(disp=2), 1),
    (ParallelConfig(space=2), 1), (ParallelConfig(sync_bn=False), 1)])
def test_check_parallel_refuses(parallel, world):
    with pytest.raises(ValueError):
        check_parallel(parallel, world)


US3D = {stage: dict(maxdisp=64, topk=24, att_weights_only=stage == 1) for stage in (1, 2)}


@pytest.mark.parametrize("parallel,world,model,match", [
    (ParallelConfig(disp=4), 4, US3D[2], "/4 top-k concat volume's 24 planes"),
    (ParallelConfig(data=1, disp=4), 4, US3D[2], "/4 top-k concat"),
    (ParallelConfig(disp=2), 2, MODEL, "/8 cosine volume's 4 planes"),
    (ParallelConfig(disp=8), 8, US3D[1], "/8 cosine volume's 16 planes"),
    (ParallelConfig(disp=2, space=2), 4, US3D[2], "spatial parallelism together are not "
     "ported yet"),
    (ParallelConfig(disp=3), 4, None, "disp=3 does not divide")])
def test_check_parallel_refuses_what_does_not_split(parallel, world, model, match):
    """A disp whose slabs do not hold a multiple of 4 planes of each volume
    (naming the volume), a disp split beside a spatial one, and a disp that
    does not divide the processes."""
    with pytest.raises(ValueError, match=match):
        check_parallel(parallel, world, None if model is None else ModelConfig(**model))


@pytest.mark.parametrize("parallel,world,model", [
    (ParallelConfig(disp=2), 2, US3D[2]), (ParallelConfig(disp=4), 4, US3D[1]),
    (ParallelConfig(data=2, disp=2), 4, US3D[2]),
    (ParallelConfig(disp=2), 2, dict(name="SemStereo_WHU", maxdisp=64)),
    (ParallelConfig(data=-1, disp=2), 8, US3D[1])])
def test_check_parallel_accepts_the_plane_count_table(parallel, world, model):
    """data x disp = world for the disps of each volume's plane count: US3D
    stage 2 (16 and 24 planes) at 1 and 2, stage 1 (16) at 1, 2 and 4, WHU
    at maxdisp 64 (8 and 16) at 1 and 2."""
    check_parallel(parallel, world, ModelConfig(**model))


# (space, height, model): the height rules of parallel.check_space_rows, each
# broken once, with the level and the rows its message names
HEIGHT_RULES = [
    (2, 1000, US3D[2], "125 rows at /4, which the stride-2 conv to /8"),
    (2, 1048, US3D[2], "131 rows at /4, which the stride-2 conv to /8"),
    (4, 1056, US3D[2], "33 rows at /8, where the MobileViTv2 block's 2x2 patches"),
    (2, 1088, US3D[2], "17 rows at /32, where the MobileViTv2 block's 2x2 patches"),
    (32, 1024, US3D[2], "1 rows at /32, where the MobileViTv2 block's 2x2 patches"),
    (16, 1024, US3D[2], "2 rows at /32, which hourglass_att's attention windows of 4"),
    (4, 1152, US3D[2], "9 rows at /32, where the MobileViTv2"),
    (16, 1024, dict(US3D[2], att_window1=(4, 2, 4), att_window2=(6, 8, 4)),
     "4 rows at /16, which hourglass's attention windows of 8"),
    (3, 1024, US3D[2], "1024 rows do not split into 3 slabs")]


@pytest.mark.parametrize("space,height,model,match", HEIGHT_RULES)
def test_check_parallel_refuses_what_breaks_a_height_rule(space, height, model, match):
    """A space whose slabs break a height rule, named by its level and rows
    (the processes themselves split: the rule is the height's)."""
    check_parallel(ParallelConfig(space=space), space, ModelConfig(**model))
    with pytest.raises(ValueError, match=match):
        check_space_rows(height, space, ModelConfig(**model))


@pytest.mark.parametrize("parallel,world,model,height", [
    (ParallelConfig(space=2), 2, US3D[2], 1024), (ParallelConfig(space=4), 4, US3D[2], 1024),
    (ParallelConfig(space=8), 8, US3D[2], 1024), (ParallelConfig(space=8), 8, US3D[1], 1024),
    (ParallelConfig(data=2, space=2), 4, US3D[2], 1024),
    (ParallelConfig(data=-1, space=2), 8, US3D[2], 1024),
    (ParallelConfig(space=2), 2, MODEL, 128), (ParallelConfig(space=2), 2, None, None)])
def test_check_parallel_accepts_the_height_rules(parallel, world, model, height):
    """data x space = world at the heights the rules allow: US3D's 1024
    rows at space 2, 4 and 8 (64 rows a slab at /32 hold 2 of hourglass_att's
    windows of 4 rows at space 8), the tiny model's 128 rows at 2."""
    model = None if model is None else ModelConfig(**model)
    check_parallel(parallel, world, model)
    if height is not None:
        check_space_rows(height, parallel.space, model)
