"""Disparity and spatial parallelism of the port together on the CPU: the
cost volumes' planes and the images' rows split over four gloo processes
at ``disp 2 x space 2`` (``parallel.make_mesh``'s whole ``(data, disp,
space)`` mesh), against the JAX package (its whole-volume modules and
``shard_disp`` with ``shard_spatial``) and against one process of the
port.

The tiny model of tests/test_torch_space_parallel.py: H 128 x W 64,
maxdisp 32, ``topk`` = ``refine_topk`` = 16, attention windows (1, 2, 2).
Its /8 volume's 8 planes and its 16 top-k planes split into slabs of 4 and
8 at disp 2, and its 128 rows into slabs of 64 at space 2; every /4 plane
is kept, so no hard choice of a plane sits on the eval's or the gradient's
path.  fp32 throughout.

* (i) Modules against JAX: the 3x3x3 conv at stride 1 and 2 and the k3 s2
  p1 op1 volume deconv, each with train BatchNorm and its activation, on
  the four processes' (plane, row) slabs against the JAX package's
  ``BasicConv(dims=3)`` on the whole volume: y (rtol 1e-4, atol 1e-5), dx
  and the kernel's and BatchNorm's gradients summed over the processes
  (rtol 1e-4, atol 1e-4); measured at most 1.9e-6 on y, 1.3e-5 on dx and
  3.1e-5 on a gradient.  ``conv_s1_corner``'s input is zero but for the
  block of the last plane of the first plane slab and the last row of the
  first row slab, which reaches the process of disp index 1 and space
  index 1 only as its corner halo (and its dx only back through it).
* (ii) Eval: a four-process eval against the JAX package's
  ``SemStereo(shard_disp=True, shard_spatial=True)`` under
  ``make_mesh(data=1, disp=2, space=2)`` on the 8-device CPU mesh, from
  the same numpy-made weights (``load_flax_variables``): ``label_l`` rtol
  1e-4, atol 1e-4 (measured 2.0e-5), the disparity within 2e-3 px
  (measured 5.8e-4 px on disparities of about 20, where the one-process
  port is 7.4e-4 px from JAX); and against the one-process port eval
  within 2e-3 px (measured 3.5e-4 px).  The two processes of a row slab
  hold equal outputs, bit for bit.
* (iii) Train steps at ``disp 2 x space 2`` (four processes), ``data 2 x
  disp 2 x space 2`` (eight, the JAX package's composed mesh of
  tests/test_train_integration.py) and ``space 4`` (four, at H 256: a slab
  of 64 rows holds 2 rows at /32, the least ``check_space_rows`` allows)
  against the port's one-process step from the same weights and global
  batch of 2, under the bounds of tests/test_torch_disp_parallel.py: loss
  terms 2e-5 (relative; D1 and Thres1-3 also one pixel's share), running
  means 1e-5 of their channel's standard deviation, variances 2e-5, the
  whole gradient 0.02, the worst leaf 0.1, Adam's parameters 1e-6 where
  both gradients share a sign and are at least 1e-4.  Measured (disp 2 x
  space 2 / data 2 x disp 2 x space 2 / space 4): loss terms 3.0e-6 /
  5.0e-6 / 3.5e-6, means 1.6e-6 / 1.7e-6 / 1.1e-6, variances 7.3e-6 /
  7.2e-6 / 4.6e-6, whole gradient 0.0070 / 0.0067 / 0.0102, worst leaf
  0.014 / 0.012 / 0.014, Adam's parameters 1.2e-7 in each.  Every process
  holds bitwise-equal gradients and parameters after the step.
* (iv) CLI: ``cli.train --disp-parallel 2 --space-parallel 2`` against
  the one-process ``cli.train``: every process loads the one process's
  rows, each step prints the one process's losses (to the 3 printed
  decimals, then rtol 0.02 after an Adam step), the checkpoint's
  parameters are within the Adam bounds of tests/test_torch_parallel.py,
  the eval epoch's results equal the one-process ``cli.evaluate`` of that
  checkpoint within rtol 1e-5, and its ``--save-dir`` dump (rows gathered
  over each space group, written by the process of disp and space index 0)
  holds the one-process dump's files, their 256 x uint16 disparities at
  most one level apart (the space file's bound).  Then ``cli.evaluate
  --disp-parallel 2 --space-parallel 2`` of the same checkpoint, in the
  same four processes, gives the one-process results within rtol 1e-5
  and the same dump.
* ``broadcast_from_group`` at ``disp 2 x space 2`` and ``data 2 x disp 2
  x space 2``: each disp group (one per (data, space) pair) broadcasts
  from its own first process, global rank ``data_index * disp * space +
  space_index``, a value that differs by group.

Each process is a subprocess with its own timeout, running ``_worker``
below with ``RANK`` and ``WORLD_SIZE`` set as ``torchrun`` sets them; the
three runs go at once, beside the JAX eval.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from semstereo_tpu_torch.cli import evaluate as cli_evaluate
from semstereo_tpu_torch.cli import train as cli_train
from semstereo_tpu_torch.config import ModelConfig, ParallelConfig, TrainConfig
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.models import SemStereo
from tests._torch_threads import two_torch_threads  # noqa: F401
from tests.test_torch_disp_parallel import (
    _load_module,
    _port_module,
    _step_levels,
    _step_results,
)
from tests.test_torch_parallel import _free_port, _loss_terms
from tests.test_torch_space_parallel import (
    CLI_FLAGS,
    H,
    LR,
    MODEL,
    PIXEL_SHARE,
    STEP_BOUNDS,
    TEST_ROWS,
    TRAIN_ROWS,
    W,
    _write_us3d,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISP, SPACE = 2, 2
TIMEOUT = 400
# The runs: (data, disp, space, image height).  space 4 needs 256 rows: a
# slab of 64 holds 2 rows at /32, the least check_space_rows allows.
RUNS = {"disp2_space2": (1, DISP, SPACE, H), "data2_disp2_space2": (2, DISP, SPACE, H),
        "space4": (1, 1, 4, 2 * H)}
# (i): (name, x shape [B, D, H, W, C], F, stride, deconv); D and H split in two
MODULES = [("conv_s1", (1, 8, 8, 6, 8), 8, 1, False),
           ("conv_s1_corner", (1, 8, 8, 6, 8), 8, 1, False),
           ("conv_s2", (1, 8, 8, 6, 8), 16, 2, False),
           ("deconv", (1, 4, 4, 3, 16), 8, 2, True)]


def _cfg(disp=1, space=1):
    return TrainConfig(model=ModelConfig(**MODEL),
                       parallel=ParallelConfig(disp=disp, space=space))


def _slab(x, mesh):
    """This process's slab of planes (axis 1) of its slab of rows (axis 2)."""
    p0, n = mesh.slab(x.shape[1])
    r0, m = mesh.row_slab(x.shape[2])
    return x[:, p0:p0 + n, r0:r0 + m]


def _module_slab(case, mesh, stride, deconv):
    """The port's module on this process's (plane, row) slab: (y slab, dx
    slab, dw, dscale, dbias) for the cotangent's slab."""
    from semstereo_tpu_torch.nn.layers import split_rows

    x = torch.from_numpy(case["x"])
    module = _port_module(stride, deconv, x.shape[-1], case["kernel"].shape[-1]).train()
    _load_module(module, case)
    split_rows(module, mesh)
    xs = _slab(x, mesh).clone().requires_grad_()
    y = module(xs, relu=True, mesh=mesh) if deconv else module(xs, mesh=mesh)
    y.backward(_slab(torch.from_numpy(case["gy"]), mesh))
    conv = module[0] if deconv else module.conv
    bn = module[1] if deconv else module.bn
    return (y.detach(), xs.grad, conv.weight.grad.clone(), bn.weight.grad.clone(),
            bn.bias.grad.clone())


def _outputs(model, left, right) -> dict:
    with torch.inference_mode():
        out = model(left, right)
    return {k: (v[0] if isinstance(v, tuple) else v).float() for k, v in out.items()}


def _batch(height, data_index, data):
    """This data shard's rows of the global batch of 2 at ``height`` x W."""
    batch = SyntheticStereoDataset(2, height, W, 32).batch(0, 2)
    return {k: v[data_index::data] for k, v in batch.items()}


def _worker():
    """One process of a run (``$TAG``: ``RUNS``' mesh and height); process
    0 takes the one-process step first, before it joins the group.  The
    ``disp2_space2`` run goes on to the modules, the eval and the CLIs.  The
    results go to ``$OUT_DIR/<tag>_rank<r>.pt``."""
    from semstereo_tpu_torch import parallel

    torch.set_num_threads(1)
    tag = os.environ["TAG"]
    data, disp, space, height = RUNS[tag]
    want = (_step_results(_cfg(), _batch(height, 0, 1)) if os.environ["RANK"] == "0"
            else None)
    parallel.init_process_group("cpu")
    mesh = parallel.make_mesh(data, disp, space)
    rank, out_dir = parallel.process_index(), os.environ["OUT_DIR"]
    out = {"mesh": (mesh.data, mesh.disp, mesh.space, mesh.data_index, mesh.disp_index,
                    mesh.space_index)}
    if disp > 1:
        out["broadcast"] = int(parallel.broadcast_from_group(
            torch.tensor([100 + rank]), mesh).item())
    got = _step_results(_cfg(disp, space), parallel.slab_rows(
        _batch(height, mesh.data_index, mesh.data), mesh), mesh)
    try:  # every process holds process 0's gradients and parameters, bit for bit
        parallel.broadcast_check([*got[2].values(), *got[3].values()], "gradients or parameters")
        out["equal"] = True
    except RuntimeError:
        out["equal"] = False
    if want is not None:
        out["plain"] = _step_levels(want, got)
    if tag != "disp2_space2":
        torch.save(out, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))
        torch.distributed.destroy_process_group()
        return
    cases = torch.load(os.path.join(out_dir, "cases.pt"), weights_only=False)
    out["modules"] = {name: _module_slab(cases["modules"][name], mesh, stride, deconv)
                      for name, _, _, stride, deconv in MODULES}
    model = SemStereo(**MODEL, mesh=mesh).eval()
    model.load_state_dict(cases["eval_weights"])
    r0, m = mesh.row_slab(H)
    left, right = (torch.from_numpy(a)[:, r0:r0 + m] for a in cases["eval_pair"])
    out["eval"] = _outputs(model, left, right)
    flags = ["--disp-parallel", str(DISP), "--space-parallel", str(SPACE)]
    trainer = cli_train.main([*sys.argv[1:], *flags])
    trainer.evaluate(save_dir=os.path.join(out_dir, "dump_train"))
    out["cli"] = dict(eval=trainer.history[-1]["eval"], rows=trainer.train_loader._indices(),
                      shard=(trainer.train_loader.shard_index,
                             trainer.train_loader.shard_count))
    del trainer
    argv = sys.argv[1:]
    root = argv[argv.index("--datapath") + 1]
    out["evaluate"] = cli_evaluate.main([
        "--preset", "us3d_stage2", *CLI_FLAGS, "--batch-size", "2", "--device", "cpu",
        "--datapath", root, "--testlist", f"{root}/test.txt", "--loadckpt",
        argv[argv.index("--logdir") + 1], "--save-dir", os.path.join(out_dir, "dump_evaluate"),
        *flags])
    torch.save(out, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _start(tmp, tag, argv):
    data, disp, space, _ = RUNS[tag]
    world = data * disp * space
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OUT_DIR=str(tmp), TAG=tag, PYTHONPATH=ROOT)
    code = "from tests.test_torch_disp_space_parallel import _worker; _worker()"
    return [subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT,
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(tmp, tag, procs):
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
        assert p.returncode == 0, f"{tag} rank {r} failed:\n{text[-4000:]}"
    return [torch.load(tmp / f"{tag}_rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _module_cases():
    rng = np.random.default_rng(29)
    cases = {}
    for name, xshape, f, stride, deconv in MODULES:
        c = xshape[-1]
        out = [n * 2 if deconv else n // stride for n in xshape[1:4]]
        x = rng.standard_normal(xshape).astype(np.float32)
        if name.endswith("corner"):  # the corner block of the slab at (disp 1, space 1)
            block = x[:, xshape[1] // 2 - 1, xshape[2] // 2 - 1].copy()
            x[:] = 0.0
            x[:, xshape[1] // 2 - 1, xshape[2] // 2 - 1] = block
        cases[name] = dict(
            x=x, kernel=(rng.standard_normal((3, 3, 3, c, f)) / np.sqrt(27 * c)).astype(np.float32),
            scale=(1 + 0.1 * rng.standard_normal(f)).astype(np.float32),
            bias=(0.1 * rng.standard_normal(f)).astype(np.float32),
            gy=rng.standard_normal((xshape[0], *out, f)).astype(np.float32))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The numpy-made inputs, the four-process run, the JAX eval and the
    CLI's data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from semstereo_tpu.models import SemStereo as JaxSemStereo
    from semstereo_tpu.parallel import make_mesh as jax_make_mesh
    from tests.test_torch_model import _numpy_variables

    tmp = tmp_path_factory.mktemp("disp_space")
    cases = {"modules": _module_cases()}
    params, stats = _numpy_variables(JaxSemStereo(num_classes=6, **MODEL), seed=4)
    model = SemStereo(**MODEL).eval()
    load_flax_variables(model, params, stats)
    rng = np.random.default_rng(7)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    left = np.roll(right, 6, axis=2)
    cases.update(eval_weights=model.state_dict(), eval_pair=(left, right))
    torch.save(cases, tmp / "cases.pt")

    root = str(tmp / "data")
    rows = _write_us3d(root, TRAIN_ROWS + TEST_ROWS)
    for name, part in (("train", rows[:TRAIN_ROWS]), ("test", rows[TRAIN_ROWS:])):
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    argv = ["--preset", "us3d_stage2", "--datapath", root, "--trainlist", f"{root}/train.txt",
            "--testlist", f"{root}/test.txt", *CLI_FLAGS, "--batch-size", "2",
            "--test-batch-size", "2", "--epochs", "1", "--save-freq", "1", "--num-workers", "1",
            "--device", "cpu", "--logdir", str(tmp / "run")]
    procs = {tag: _start(tmp, tag, argv if tag == "disp2_space2" else []) for tag in RUNS}

    jmodel = JaxSemStereo(num_classes=6, shard_disp=True, shard_spatial=True, **MODEL)
    mesh = jax_make_mesh(data=1, disp=DISP, space=SPACE)
    rep = NamedSharding(mesh, PartitionSpec())
    with jax.set_mesh(mesh):
        put = jax.device_put({"params": params, "batch_stats": stats}, rep)
        jout = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
            put, jax.device_put(jnp.asarray(left), rep), jax.device_put(jnp.asarray(right), rep))
        jout = jax.tree_util.tree_map(np.asarray, jout)
    with torch.inference_mode():
        one = model(torch.from_numpy(left), torch.from_numpy(right))
    runs = {tag: _wait(tmp, tag, p) for tag, p in procs.items()}
    return dict(runs, ranks=runs["disp2_space2"], cases=cases, argv=argv, tmp=tmp, root=root,
                jax_eval=jout, one_eval=one)


def _gather(parts, plane_axis, row_axis):
    """The whole from the four processes' (plane, row) slabs, ranks in mesh
    order (rank = disp_index * space + space_index); ``plane_axis`` None for
    an output held whole along the planes (by every process of a disp
    group alike: process 0's row slab group is taken)."""
    parts = list(parts)
    by_plane = [torch.cat(parts[p * SPACE:(p + 1) * SPACE], row_axis) for p in range(DISP)]
    return by_plane[0] if plane_axis is None else torch.cat(by_plane, plane_axis)


@pytest.mark.parametrize("tag", RUNS)
def test_mesh_lays_out_data_disp_space(runs, tag):
    """rank = d * disp * space + p * space + s, as the JAX package's
    ``make_mesh`` lays out devices."""
    data, disp, space, _ = RUNS[tag]
    assert [r["mesh"] for r in runs[tag]] == [(data, disp, space, d, p, s) for d in range(data)
                                              for p in range(disp) for s in range(space)]


@pytest.mark.parametrize("tag", ["disp2_space2", "data2_disp2_space2"])
def test_broadcast_from_group_takes_the_disp_groups_first_process(runs, tag):
    """Each disp group, one per (data, space) pair, holds its own first
    process's value (global rank d * disp * space + s), not another
    group's."""
    data, disp, space, _ = RUNS[tag]
    assert [r["broadcast"] for r in runs[tag]] == [
        100 + d * disp * space + s for d in range(data) for _ in range(disp)
        for s in range(space)]


@pytest.mark.parametrize("name,xshape,f,stride,deconv", MODULES)
def test_two_axis_haloed_module_matches_jax(runs, name, xshape, f, stride, deconv):
    """(i): the module on four processes' (plane, row) slabs, gathered,
    against the JAX package's ``BasicConv(dims=3)`` on the whole volume: y,
    dx, and the kernel's and BatchNorm's gradients (summed over the
    processes)."""
    import jax
    import jax.numpy as jnp

    from semstereo_tpu.nn.layers import BasicConv as JaxBasicConv

    case = runs["cases"]["modules"][name]
    jmod = JaxBasicConv(f, 3, stride, 1, dims=3, deconv=deconv,
                        output_padding=1 if deconv else 0)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(case["x"]), train=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["conv"]["kernel"] = case["kernel"]
    params["bn"]["scale"], params["bn"]["bias"] = case["scale"], case["bias"]

    def apply(p, x):
        y, _ = jmod.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                          train=True, mutable=["batch_stats"])
        return y

    y, vjp = jax.vjp(apply, params, jnp.asarray(case["x"]))
    gp, gx = vjp(jnp.asarray(case["gy"]))
    got = [r["modules"][name] for r in runs["ranks"]]
    np.testing.assert_allclose(_gather((g[0] for g in got), 1, 2).numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_gather((g[1] for g in got), 1, 2).numpy(), np.asarray(gx),
                               rtol=1e-4, atol=1e-4)
    layout = (2, 3, 4, 0, 1) if deconv else (2, 3, 4, 1, 0)
    np.testing.assert_allclose(sum(g[2] for g in got).permute(*layout).numpy(),
                               np.asarray(gp["conv"]["kernel"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(g[3] for g in got).numpy(), np.asarray(gp["bn"]["scale"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(g[4] for g in got).numpy(), np.asarray(gp["bn"]["bias"]),
                               rtol=1e-4, atol=1e-4)


def test_disp_space_eval_matches_jax(runs):
    """(ii): the row slabs, gathered, against JAX's ``shard_disp`` +
    ``shard_spatial`` eval and the one-process port eval; the processes of
    a disp group hold equal outputs."""
    want, one = runs["jax_eval"], runs["one_eval"]
    ranks = runs["ranks"]
    for s in range(SPACE):
        for k in ("label_l", "disp"):
            assert torch.equal(ranks[s]["eval"][k], ranks[SPACE + s]["eval"][k]), (s, k)
    got = {k: _gather((r["eval"][k] for r in ranks), None, 1) for k in ("label_l", "disp")}
    np.testing.assert_allclose(got["label_l"].numpy(), want["label_l"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["disp"].numpy(), want["disp"][0], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["disp"].numpy(), one["disp"][0].numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("tag", RUNS)
def test_split_step_matches_one_process(runs, tag):
    """(iii): disp 2 x space 2, data 2 x disp 2 x space 2 and space 4
    against one process at the global batch of 2 (``STEP_BOUNDS``, the
    differences taken in process 0); every process's gradients and
    parameters equal process 0's."""
    ranks = runs[tag]
    assert all(r["equal"] for r in ranks)
    levels, b = ranks[0]["plain"], STEP_BOUNDS
    got, want = levels["scalars"]
    assert set(got) == set(want)
    for k, v in want.items():
        tol = PIXEL_SHARE if k in ("D1", "Thres1", "Thres2", "Thres3") else 0.0
        np.testing.assert_allclose(got[k], v, rtol=b["loss"], atol=tol + 1e-7, err_msg=k)
    assert levels["mean"] <= b["mean"] and levels["var"] <= b["var"], levels
    assert levels["whole"] <= b["whole"], levels["whole"]
    assert levels["leaf"] <= b["leaf"], (levels["leaf_worst"], levels["leaf"])
    assert levels["zero"] <= 1e-7 and levels["leaves"] > 0.9 * levels["grads"], levels
    assert levels["adam_step"] <= 2 * LR + 1e-6 and levels["adam_sure"] <= b["adam"], levels
    assert levels["adam_held"] >= 1e5, levels["adam_held"]


def _dump_levels(a_dir, b_dir):
    """The files of two dumps and the largest difference of their
    disparities, in 1/256 px levels."""
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and len(names) == TEST_ROWS
    worst = 0
    for n in names:
        a, b = (np.asarray(Image.open(os.path.join(d, n))).astype(np.int64)
                for d in (a_dir, b_dir))
        assert a.shape == (H, W), n
        worst = max(worst, int(np.abs(a - b).max()))
    return worst


def test_disp_space_clis_match_one_process(runs, tmp_path, capsys):
    """(iv): ``cli.train --disp-parallel 2 --space-parallel 2`` loads the
    one process's rows on every process, prints each step's losses as one
    process does, writes a checkpoint within Adam's bounds of the
    one-process run's; its eval epoch and its ``cli.evaluate`` with the same
    flags equal the one-process ``cli.evaluate`` of that checkpoint, and
    both dumps hold the one-process dump's files."""
    run = str(runs["tmp"] / "run")
    capsys.readouterr()
    one = cli_train.main([*runs["argv"][:-1], str(tmp_path / "one")])
    one_log = capsys.readouterr().out
    ranks = runs["ranks"]
    for r in ranks:
        assert r["cli"]["shard"] == (0, 1)
        np.testing.assert_array_equal(r["cli"]["rows"], one.train_loader._indices())
    log = open(os.path.join(run, "log.log")).read()
    steps = TRAIN_ROWS // 2
    for it, (rtol, atol) in enumerate([(0.0, 1.5e-3), (0.02, 0.0)]):
        prefix = f"Epoch 0/1, Iter {it}/{steps}"
        np.testing.assert_allclose(_loss_terms(log, prefix), _loss_terms(one_log, prefix),
                                   rtol=rtol, atol=atol)
    sd4 = torch.load(os.path.join(run, "checkpoint_000000.pt"), weights_only=True)
    sd1 = torch.load(tmp_path / "one" / "checkpoint_000000.pt", weights_only=True)
    assert sd4["model"].keys() == sd1["model"].keys()
    diffs = torch.cat([(sd4["model"][n] - p).abs().ravel() for n, p in sd1["model"].items()
                       if "running_" not in n]) / LR
    assert float(diffs.max()) <= 4.003, float(diffs.max())
    assert float(diffs.median()) <= 0.25, float(diffs.median())
    dump = str(tmp_path / "dump_one")
    want = cli_evaluate.main(["--preset", "us3d_stage2", *CLI_FLAGS, "--batch-size", "2",
                              "--device", "cpu", "--datapath", runs["root"], "--testlist",
                              f"{runs['root']}/test.txt", "--loadckpt", run,
                              "--save-dir", dump])
    for r in ranks:
        for got in (r["cli"]["eval"], r["evaluate"]):
            assert set(got) == set(want)
            for k, v in want.items():
                tol = PIXEL_SHARE if k in ("D1", "Thres1", "Thres2", "Thres3") else 0.0
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=tol + 1e-7, err_msg=k)
    for split_dump in ("dump_train", "dump_evaluate"):
        assert _dump_levels(dump, str(runs["tmp"] / split_dump)) <= 1, split_dump
