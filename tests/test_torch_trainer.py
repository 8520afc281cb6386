"""The port's config presets, Trainer and CLIs, on the CPU.

* Every field the port's ``TrainConfig`` shares with the JAX package's has
  the JAX value in every preset.
* One epoch of the port's ``Trainer`` (tiny config: maxdisp 16, windows
  (1,2,2), 32x32) trains, evaluates and writes a checkpoint.
* ``Trainer.evaluate`` on a 3-row US3D list on disk at test batch 2 (a
  ragged final batch) against the JAX package's ``Trainer.evaluate`` with
  the same numpy weights, in both seg aggregation modes.  Tolerances: the
  losses and EPE rtol 1e-3 (fp32 reassociation through ~40 convs); D1 and
  Thres1-3 within one pixel's share of an image, 1 / (32 * 32), since a
  pixel whose error sits at a threshold can fall on either side; PA, MPA,
  mIoU and the per-class CPA/IoU within 1e-3 (a class map differs where two
  logits tie to within rounding).  The ``--save-dir`` dumps have JAX's
  names, dtype and shape, and agree within one unit (1/256 px) but on at
  most 2 % of pixels (planes that tie within rounding can enter the top k
  in one run and not the other).
* The ragged final batch, padded, gives the disparity metrics and the
  confusion matrix of the unpadded rows.
* ``cli.train.main`` / ``cli.evaluate.main`` with ``--device cpu``: stage 1,
  stage 2 from the stage-1 checkpoint, a resumed second epoch, evaluation.
"""

import dataclasses
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semstereo_tpu import config as jconfig
from semstereo_tpu.data import Us3dDataset as JUs3dDataset
from semstereo_tpu.train.state import TrainState as JTrainState
from semstereo_tpu.train.state import build_model as jbuild_model
from semstereo_tpu.train.trainer import Trainer as JTrainer
from semstereo_tpu_torch import config
from semstereo_tpu_torch.cli import evaluate as cli_evaluate
from semstereo_tpu_torch.cli import train as cli_train
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.data import SyntheticStereoDataset, Us3dDataset
from semstereo_tpu_torch.train import checkpoint as ckpt
from semstereo_tpu_torch.train import init_state, make_eval_step
from semstereo_tpu_torch.train.trainer import Trainer, _device_batch
from tests._torch_threads import two_torch_threads  # noqa: F401

S = 32
TINY = dict(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2))
TINY_FLAGS = ["--maxdisp", "16", "--topk", "4", "--att-window1", "1,2,2",
              "--att-window2", "1,2,2"]
LOSS_RTOL = 1e-3
PIXEL_SHARE = 1.0 / (S * S)
SEG_ATOL = 1e-3


def _shared_fields_equal(port, ref, path=""):
    for f in dataclasses.fields(port):
        assert hasattr(ref, f.name), f"{path}{f.name} is not a JAX field"
        p, r = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(p):
            _shared_fields_equal(p, r, f"{path}{f.name}.")
        else:
            assert p == r, (f"{path}{f.name}", p, r)


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_preset_fields_have_the_jax_values(preset):
    assert set(config.TRAIN_PRESETS) == set(jconfig.PRESETS)
    _shared_fields_equal(config.TRAIN_PRESETS[preset], jconfig.PRESETS[preset])
    assert config.PRESETS[preset] == config.TRAIN_PRESETS[preset].model


def _write_us3d(root, n, seed=0):
    """A US3D-format list of ``n`` rows: PNG views, float-TIFF disparity in
    the symmetric range, PNG labels."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
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


def _numpy_variables(seed):
    """He-normal kernels, perturbed BN statistics and affine, x8 classifier
    output kernels, shaped by the JAX model's ``eval_shape``."""
    jmodel = jbuild_model(jconfig.TrainConfig(model=jconfig.ModelConfig(**TINY)))
    dummy = jnp.zeros((1, S, S, 3), jnp.float32)
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
def evals(tmp_path_factory):
    """Both packages' evaluate over one 3-row list, batch 2, in both seg
    modes, with dumps; and the port's unpadded per-batch scalars."""
    root = str(tmp_path_factory.mktemp("us3d"))
    rows = _write_us3d(root, 3)
    lst = os.path.join(root, "test.txt")
    with open(lst, "w") as f:
        f.write("\n".join(rows) + "\n")
    params, stats = _numpy_variables(seed=4)
    data = dict(datapath=root, trainlist="", testlist=lst, batch_size=2, test_batch_size=2,
                num_workers=1)
    jcfg = jconfig.TrainConfig(model=jconfig.ModelConfig(**TINY),
                               data=jconfig.DataConfig(**data),
                               parallel=jconfig.ParallelConfig(data=1))
    cfg = config.TrainConfig(model=config.ModelConfig(**TINY), data=config.DataConfig(**data))
    jt = JTrainer(jcfg, eval_dataset=JUs3dDataset(root, lst, False))
    jt.state = JTrainState(params=params, batch_stats=stats, opt_state=None)
    pt = Trainer(cfg, eval_dataset=Us3dDataset(root, lst, False), device="cpu")
    pt.initialize()
    load_flax_variables(pt.state.model, params, stats)
    out = {"dump": {}}
    for per_batch in (False, True):
        jt.cfg = jt.cfg.replace(eval_seg_per_batch=per_batch)
        pt.cfg = pt.cfg.replace(eval_seg_per_batch=per_batch)
        dumps = {name: str(tmp_path_factory.mktemp(name)) for name in ("jax", "port")}
        out[per_batch] = (pt.evaluate(0, save_dir=dumps["port"]),
                          jt.evaluate(0, save_dir=dumps["jax"]))
        out["dump"] = dumps
    step = make_eval_step(cfg)
    batches = list(pt.eval_loader)
    out["unpadded"] = [step(pt.state, _device_batch(b, ("left", "right", "disparity", "label"),
                                                    torch.device("cpu"))) for b in batches]
    out["rows"] = [len(b["left_filename"]) for b in batches]
    return out


@pytest.mark.parametrize("per_batch", [False, True])
def test_evaluate_matches_jax(evals, per_batch):
    got, want = evals[per_batch]
    assert set(got) == set(want)
    assert {"EPE", "D1", "Thres1", "loss", "label_loss", "PA", "mIoU", "CPA0", "IoU4"} <= set(got)
    for k, w in want.items():
        g = float(got[k])
        if k in ("disp_loss", "EPE", "label_loss", "loss"):
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, err_msg=k)
        elif k == "D1" or k.startswith("Thres"):
            assert abs(g - w) <= PIXEL_SHARE, (k, g, w)
        else:
            assert abs(g - w) <= SEG_ATOL or (np.isnan(g) and np.isnan(w)), (k, g, w)


def test_evaluate_dumps_match_jax(evals):
    dumps = evals["dump"]
    names = [sorted(os.path.basename(p) for p in glob.glob(os.path.join(dumps[k], "*.png")))
             for k in ("port", "jax")]
    assert names[0] == names[1] == ["l0_disp.png", "l1_disp.png", "l2_disp.png"]
    for name in names[0]:
        got = np.asarray(Image.open(os.path.join(dumps["port"], name)))
        want = np.asarray(Image.open(os.path.join(dumps["jax"], name)))
        assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape == (S, S)
        off = np.abs(got.astype(np.int64) - want.astype(np.int64)) > 1
        assert off.mean() <= 0.02, (name, off.mean())


def test_ragged_final_batch_gives_the_unpadded_results(evals):
    """The padded batch of one real row adds nothing of its padding to the
    disparity losses and metrics, nor to the confusion matrix: the means
    over the unpadded batches give the same results.  (The label loss's
    dice term sums the predicted probabilities of every row, padded ones
    included, in both packages; ``test_evaluate_matches_jax`` holds it.)"""
    assert evals["rows"] == [2, 1]
    got = evals[False][0]
    steps = evals["unpadded"]
    for k in ("disp_loss", "EPE", "D1", "Thres1", "Thres2", "Thres3"):
        want = np.mean([float(s[k]) for s in steps])
        np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-6, err_msg=k)
    cm = sum(s["confusion"].numpy().astype(np.float64) for s in steps)
    np.testing.assert_allclose(got["PA"], np.diag(cm).sum() / cm.sum(), rtol=1e-6)


def test_trainer_one_epoch_writes_a_checkpoint(tmp_path, capsys):
    cfg = config.TrainConfig(
        model=config.ModelConfig(**TINY),
        data=config.DataConfig(batch_size=2, test_batch_size=2, num_workers=1),
        optim=config.OptimConfig(epochs=1, lrepochs="12:2"),
        logdir=str(tmp_path / "run"), save_freq=1)
    trainer = Trainer(cfg, train_dataset=SyntheticStereoDataset(4, S, S, 16),
                      eval_dataset=SyntheticStereoDataset(2, S, S, 16, training=False),
                      device="cpu")
    state = trainer.train()
    assert state.epoch == 1
    assert ckpt.latest_epoch(cfg.logdir) == 0
    assert os.listdir(cfg.logdir) == ["checkpoint_000000.pt"]
    (record,) = trainer.history
    assert len(record["step_s"]) == 2 and record["train_s"] > 0 and record["eval_s"] > 0
    printed = capsys.readouterr().out
    assert "Epoch 0/1, Iter 1/2, loss = " in printed and "avg_test_scalars" in printed
    results = trainer.evaluate(0)
    assert np.isfinite(results["EPE"]) and {"PA", "mIoU"} <= set(results)


def test_trainer_without_a_train_list_says_so(tmp_path):
    cfg = config.TrainConfig(model=config.ModelConfig(**TINY), data=config.DataConfig(
        trainlist=str(tmp_path / "missing.txt")), logdir=str(tmp_path / "run"))
    with pytest.raises(FileNotFoundError, match="missing.txt"):
        Trainer(cfg, device="cpu").train()


def test_trainer_refuses_more_than_one_process(monkeypatch):
    """Started as one of two processes (``WORLD_SIZE=2``) without having
    joined their group, the Trainer says how to join it."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2 but this process is in a group of 1"):
        Trainer(config.TrainConfig(model=config.ModelConfig(**TINY)), device="cpu")


def test_trainer_runs_on_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(config.TrainConfig(model=config.ModelConfig(**TINY)))


@pytest.mark.parametrize("flag", ["--data-parallel=2", "--disp-parallel=2",
                                  "--space-parallel=2"])
def test_train_cli_refuses_flags_of_later_slices(flag):
    """Disparity and spatial parallelism are not ported; two data-parallel
    processes need a launch of two."""
    with pytest.raises(SystemExit):
        cli_train.parse_config([flag])


@pytest.mark.parametrize("flags,field,value", [
    (["--remat"], "model.remat", True), (["--remat", "full"], "model.remat", True),
    (["--remat", "featup,concat"], "model.remat", "featup,concat"),
    (["--pretrained-backbone=x"], "model.pretrained_backbone", "x"),
    (["--data-parallel", "-1"], "parallel.data", -1)])
def test_train_cli_parses_the_training_modes(flags, field, value):
    """``--remat`` (a bare flag is "full", as the JAX CLI has it),
    ``--pretrained-backbone`` and ``--data-parallel`` land in the config."""
    cfg, _ = cli_train.parse_config(flags)
    part, name = field.split(".")
    assert getattr(getattr(cfg, part), name) == value
    assert cli_train.parse_config([])[0].model.remat is False


def test_clis_run_the_two_stage_recipe(tmp_path, capsys):
    root = str(tmp_path / "data")
    rows = _write_us3d(root, 7, seed=1)
    for name, part in (("train", rows[:4]), ("test", rows[4:])):
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    common = ["--datapath", root, "--trainlist", f"{root}/train.txt", "--testlist",
              f"{root}/test.txt", *TINY_FLAGS, "--batch-size", "2", "--test-batch-size", "2",
              "--save-freq", "1", "--num-workers", "2", "--device", "cpu"]
    run1, run2 = str(tmp_path / "stage1"), str(tmp_path / "stage2")
    stdout = sys.stdout
    cli_train.main(["--preset", "us3d_stage1", "--logdir", run1, "--epochs", "1", *common])
    assert sys.stdout is stdout
    assert "Epoch 0/1, Iter 1/2" in open(os.path.join(run1, "log.log")).read()
    capsys.readouterr()

    t2 = cli_train.main(["--preset", "us3d_stage2", "--logdir", run2, "--loadckpt", run1,
                         "--epochs", "1", *common])
    printed = capsys.readouterr().out
    cfg2 = config.TRAIN_PRESETS["us3d_stage2"].replace(
        model=config.ModelConfig(**TINY))
    _, n = ckpt.restore_partial(run1, init_state(cfg2, device="cpu"))
    assert f"partially loaded {n} tensors from {run1}" in printed and n > 0
    stage1 = torch.load(os.path.join(run1, "checkpoint_000000.pt"), weights_only=True)
    assert "hourglass.conv1.0.0.weight" not in stage1["model"]
    assert "hourglass.conv1.0.0.weight" in t2.state.model.state_dict()

    t3 = cli_train.main(["--preset", "us3d_stage2", "--logdir", run2, "--resume",
                         "--epochs", "2", *common])
    printed = capsys.readouterr().out
    assert f"resumed from {run2} at epoch 1" in printed
    assert "Epoch 1/2, Iter 0/2" in printed and "Epoch 0/" not in printed
    assert [r["epoch"] for r in t3.history] == [1]
    assert sorted(os.listdir(run2)) == ["checkpoint_000000.pt", "checkpoint_000001.pt",
                                        "log.log"]

    dump = str(tmp_path / "dump")
    results = cli_evaluate.main(["--preset", "us3d_stage2", "--loadckpt", run2, "--datapath",
                                 root, "--testlist", f"{root}/test.txt", *TINY_FLAGS,
                                 "--batch-size", "2", "--save-dir", dump, "--device", "cpu"])
    assert np.isfinite(results["EPE"]) and "mIoU" in results
    assert sorted(os.listdir(dump)) == ["l4_disp.png", "l5_disp.png", "l6_disp.png"]
    assert np.asarray(Image.open(os.path.join(dump, "l4_disp.png"))).dtype == np.uint16
