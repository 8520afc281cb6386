"""Spatial parallelism of the port on the CPU: the images' rows split over
gloo processes (``parallel.make_mesh``'s space axis), against the JAX
package (its whole-image modules and ``shard_spatial``) and against one
process of the port.

Tiny US3D model at H 128 x W 64, the smallest height that
``check_space_rows`` allows at ``space = 2`` with attention windows (1, 2,
2): a slab of 64 rows holds 2 rows at /32.  maxdisp 32 with ``topk`` =
``refine_topk`` = 16, so every /4 plane is kept and no hard choice of a
plane sits on the eval's or the gradient's path.  fp32 throughout.

* (i) Modules against JAX: the haloed 2-D conv (k3 at stride 1 and 2), the
  depthwise k3 at stride 1 and 2 (``ConvNormAct``), the k4 s2 p1 deconv,
  the 3x3x3 conv at stride 1 and 2 and the k3 s2 p1 op1 volume deconv, each
  with train BatchNorm and its activation, on the two processes' row slabs
  against the JAX package's module on the whole input: y (rtol 1e-4, atol
  1e-5), dx and the kernel's and BatchNorm's gradients summed over the
  processes (rtol 1e-4, atol 1e-4); measured at most 2.1e-6 on y, 1.9e-6
  on dx and 1.9e-5 on a gradient.
* (ii) Ops on slabs against the one-process port on the whole (which
  tests/test_torch_ops.py and the model tests hold against JAX):
  ``GroupNorm1`` (statistics over the space group), the separable
  attention (a softmax over every patch), a whole ``MobileVitV2Block`` in
  train mode, ``propagate5`` and ``propagate5_volume`` (the halo is the
  neighbour's row, a copy of the edge row only past the image), bilinear
  x2 and x4 and trilinear x2 (half-pixel, replicated edge rows): y and dx
  rtol 1e-5, atol 1e-6, and each parameter's gradient within 1e-5 of the
  op's largest gradient element (sums of hundreds of terms of up to 40
  here, in another order; measured 3.5e-7 of it at most; y 1.2e-6 and
  dx 1.4e-6 at most).  The propagations are equal bit for bit in the forward (copies of
  the same values); the resizes weigh the same two rows with the same
  weights as the whole, to one fp32 ulp (6e-8 measured).
* (iii) ``dice_loss`` on slabs, ignore 5 (a dropped class) and 255 (masked
  pixels): the processes' shares sum to the whole image's loss and to the
  JAX package's (rtol 1e-6; measured equal), and the gathered gradient is
  the whole's (rtol 1e-5, atol 1e-7; measured 7e-10 on elements up to
  3.6e-3).
* (iv) Eval: a two-process ``space = 2`` eval against the JAX package's
  ``SemStereo(shard_spatial=True)`` under ``make_mesh(data=1, disp=1,
  space=2)`` on the 8-device CPU mesh, from the same numpy-made weights:
  ``label_l`` rtol 1e-4, atol 1e-4 (measured 2.0e-5), the disparity within
  2e-3 px (measured 7.0e-4 px, where the one-process port is 5.4e-4 px
  from JAX); and against the one-process port eval within 2e-3 px
  (measured 3.5e-4 px on disparities of about 20: GroupNorm's two-pass
  statistics and the attention's softmax over the group round otherwise
  than the one-process ``var_mean`` and ``softmax``, which the net, its
  classifier kernels scaled by 8, amplifies).
* (v) Train steps: ``space = 2`` (two processes) and ``data 2 x space 2``
  (four) against the port's one-process step from the same weights and
  global batch of 2, under the bounds of tests/test_torch_disp_parallel.py:
  loss terms 2e-5 (relative; D1 and Thres1-3 also one pixel's share),
  running means 1e-5 of their channel's standard deviation, variances
  2e-5, the whole gradient 0.02, the worst leaf 0.1, Adam's parameters
  1e-6 where both gradients share a sign and are at least 1e-4.  Measured
  (space 2 / data 2 x space 2): loss terms 6.5e-6 / 5.6e-6, means 2.9e-6 /
  2.5e-6, variances 7.1e-6 / 6.1e-6, whole gradient 0.0067 / 0.0072,
  worst leaf 0.014 / 0.014, Adam's parameters 1.2e-7 / 1.2e-7.  Every
  process holds bitwise-equal gradients and parameters after the step.
* (vi) CLI: ``cli.train --space-parallel 2`` against the one-process
  ``cli.train``: both processes load the one process's rows, each step
  prints the one process's losses (to the 3 printed decimals, then rtol
  0.02 after an Adam step), the checkpoint's parameters are within the
  Adam bounds of tests/test_torch_parallel.py, and the eval epoch's
  results equal the one-process ``cli.evaluate`` of the same checkpoint
  within rtol 1e-5; the ``--save-dir`` dump of that checkpoint by the
  space group (rows gathered, written by its first process) holds the
  one-process dump's files, their 256 x uint16 disparities at most one
  level apart (measured: one level, where a disparity within rounding of
  one process's lies across a 1/256 px step).  Measured for the epoch: the
  first step's losses equal to the printed decimals, the second 5.1e-3
  apart, the checkpoints 3.99 lr apart at most and 0.12 lr at the median,
  the eval 1.1e-7 apart.

Each process is a subprocess with its own timeout, running ``_worker``
below with ``RANK`` and ``WORLD_SIZE`` set as ``torchrun`` sets them; the
two-process and four-process runs go at once, beside the JAX eval.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from semstereo_tpu_torch import losses
from semstereo_tpu_torch.cli import evaluate as cli_evaluate
from semstereo_tpu_torch.cli import train as cli_train
from semstereo_tpu_torch.config import ModelConfig, ParallelConfig, TrainConfig
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.models import SemStereo
from semstereo_tpu_torch.nn.backbone import (
    ConvNormAct,
    GroupNorm1,
    LinearSelfAttention,
    MobileVitV2Block,
)
from semstereo_tpu_torch.nn.layers import BasicConv, ConvBn, split_rows
from semstereo_tpu_torch.ops import (
    propagate5,
    propagate5_volume,
    resize_bilinear,
    resize_trilinear,
)
from tests._torch_threads import two_torch_threads  # noqa: F401
from tests.test_torch_disp_parallel import _step_levels, _step_results
from tests.test_torch_parallel import _free_port, _loss_terms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 128, 64
SPACE = 2
MODEL = dict(maxdisp=32, topk=16, refine_topk=16, att_window1=(1, 2, 2), att_window2=(1, 2, 2))
CLI_FLAGS = ["--maxdisp", "32", "--topk", "16", "--att-window1", "1,2,2", "--att-window2",
             "1,2,2"]
LR = 1e-3
PIXEL_SHARE = 1.0 / (H * W)
STEP_BOUNDS = dict(loss=2e-5, mean=1e-5, var=2e-5, whole=0.02, leaf=0.1, adam=1e-6)
TRAIN_ROWS, TEST_ROWS = 4, 3
TIMEOUT = 400
# (i): (name, x shape, F, kind, stride); H is axis 1 of [B, H, W, C] and 2 of
# [B, D, H, W, C]
MODULES = [("conv2d_s1", (1, 8, 6, 4), 8, "conv", 1),
           ("conv2d_s2", (1, 8, 6, 4), 8, "conv", 2),
           ("dwconv_s1", (1, 8, 6, 8), 8, "dw", 1),
           ("dwconv_s2", (1, 8, 6, 8), 8, "dw", 2),
           ("deconv2d", (1, 4, 3, 8), 4, "deconv", 2),
           ("conv3d_s1", (1, 4, 8, 6, 8), 8, "conv", 1),
           ("conv3d_s2", (1, 4, 8, 6, 8), 16, "conv", 2),
           ("deconv3d", (1, 2, 4, 3, 16), 8, "deconv", 2)]
# (ii): name -> (x shape, the rows' axis in x, in y)
OPS = {"groupnorm": ((2, 4, 16, 8), 2, 2), "attention": ((2, 4, 16, 8), 2, 2),
       "vit_block": ((1, 8, 6, 8), 1, 1), "propagate5": ((2, 8, 6), 1, 2),
       "propagate5_volume": ((1, 3, 8, 6), 2, 3), "bilinear_x2": ((1, 4, 6, 3), 1, 1),
       "bilinear_x4": ((1, 4, 6, 3), 1, 1), "trilinear_x2": ((1, 3, 4, 6, 1), 2, 2)}
DICE_IGNORE = (5, 255)


def _cfg(space=1):
    return TrainConfig(model=ModelConfig(**MODEL), parallel=ParallelConfig(space=space))


def _rows(data_index, data):
    """This data shard's rows of the global batch of 2."""
    batch = SyntheticStereoDataset(2, H, W, 32).batch(0, 2)
    return {k: v[data_index::data] for k, v in batch.items()}


def _slab(x, mesh, axis):
    r0, n = mesh.row_slab(x.shape[axis])
    return x.narrow(axis, r0, n)


# -- (i) modules ---------------------------------------------------------

def _port_module(kind, stride, cin, f, dims):
    if kind == "dw":
        return ConvNormAct(cin, cin, 3, stride=stride, groups=cin)
    if kind == "deconv" and dims == 3:
        return ConvBn(cin, f, 3, 2, 1, dims=3, deconv=True, output_padding=1)
    if kind == "deconv":
        return BasicConv(cin, f, 4, 2, 1, deconv=True)
    return BasicConv(cin, f, 3, stride, 1, dims=dims)


def _conv_bn(module):
    if isinstance(module, ConvBn):
        return module[0], module[1]
    return module.conv, module.bn


def _torch_layout(kind, dims):
    """The axes that take a JAX kernel [*K, Cin(/g), F] to the torch
    weight ([F, Cin/g, *K], a deconv's [Cin, F, *K])."""
    if kind == "deconv":
        return (dims, dims + 1, *range(dims))
    return (dims + 1, dims, *range(dims))


def _run_module(case, kind, stride, mesh=None):
    """(y, dx, dw, dscale, dbias) of the port's module on the rows of this
    process's slab (the whole without a mesh) for the cotangent's rows."""
    x = torch.from_numpy(case["x"])
    dims, axis = x.dim() - 2, x.dim() - 3
    module = _port_module(kind, stride, x.shape[-1], case["kernel"].shape[-1], dims).train()
    conv, bn = _conv_bn(module)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            case["kernel"].transpose(_torch_layout(kind, dims)))))
        bn.weight.copy_(torch.from_numpy(case["scale"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    split_rows(module, mesh)
    gy = torch.from_numpy(case["gy"])
    if mesh is not None:
        x, gy = _slab(x, mesh, axis), _slab(gy, mesh, axis)
    x = x.clone().requires_grad_()
    y = module(x, relu=True) if isinstance(module, ConvBn) else module(x)
    y.backward(gy)
    return (y.detach(), x.grad, conv.weight.grad.clone(), bn.weight.grad.clone(),
            bn.bias.grad.clone())


# -- (ii) ops --------------------------------------------------------------

def _op_module(name):
    """The seeded module of a module op, None for a function."""
    torch.manual_seed(11)
    if name == "groupnorm":
        m = GroupNorm1(8)
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5)
            m.bias.normal_(0, 0.1)
        return m
    if name == "attention":
        return LinearSelfAttention(8)
    if name == "vit_block":
        return MobileVitV2Block(8, 8, 1).train()
    return None


def _run_op(name, x, gy, state, mesh=None):
    """(y, dx, the parameters' gradients) of an op on ``x`` (a slab under
    ``mesh``, else the whole)."""
    module = _op_module(name)
    if module is not None:
        module.load_state_dict(state)
        split_rows(module, mesh)
    x = x.clone().requires_grad_()
    scale = {"bilinear_x2": 2, "bilinear_x4": 4, "trilinear_x2": 2}.get(name)
    if module is not None:
        y = module(x)
    elif name == "propagate5":
        y = propagate5(x, mesh)
    elif name == "propagate5_volume":
        y = propagate5_volume(x, mesh)
    elif name.startswith("bilinear"):
        y = resize_bilinear(x, (scale * x.shape[1], scale * x.shape[2]), mesh)
    else:
        y = resize_trilinear(x, tuple(2 * n for n in x.shape[1:4]), mesh)
    y.backward(gy)
    grads = {} if module is None else {n: p.grad.clone() for n, p in module.named_parameters()}
    return y.detach(), x.grad, grads


def _op_slab(cases, name, mesh):
    _, axis, y_axis = OPS[name]
    c = cases["ops"][name]
    return _run_op(name, _slab(torch.from_numpy(c["x"]), mesh, axis),
                   _slab(torch.from_numpy(c["gy"]), mesh, y_axis), c["state"], mesh)


def _dice_slab(cases, ignore, mesh=None):
    """(the loss or this process's share of it, d logits)."""
    logits, labels = (torch.from_numpy(a) for a in cases["dice"])
    if ignore == 255:
        labels = torch.where(labels == 5, 255, labels)
    if mesh is not None:
        logits, labels = _slab(logits, mesh, 1), _slab(labels, mesh, 1)
    logits = logits.clone().requires_grad_()
    loss = losses.dice_loss(logits, labels, 6, ignore, mesh)
    loss.backward()
    return loss.item(), logits.grad


# -- the processes -----------------------------------------------------------

def _outputs(model, left, right) -> dict:
    with torch.inference_mode():
        out = model(left, right)
    return {k: (v[0] if isinstance(v, tuple) else v).float() for k, v in out.items()}


def _worker():
    """One process of a run of ``$WORLD_SIZE`` processes in space groups of
    ``$SPACE``; process 0 takes the one-process step first, before it joins
    the group.  The results go to ``$OUT_DIR/<tag>_rank<r>.pt``."""
    from semstereo_tpu_torch import parallel

    torch.set_num_threads(1)
    space = int(os.environ["SPACE"])
    want = _step_results(_cfg(), _rows(0, 1)) if os.environ["RANK"] == "0" else None
    parallel.init_process_group("cpu")
    mesh = parallel.make_mesh(-1, 1, space)
    rank, out_dir, tag = parallel.process_index(), os.environ["OUT_DIR"], os.environ["TAG"]
    got = _step_results(_cfg(space), parallel.slab_rows(_rows(mesh.data_index, mesh.data),
                                                        mesh), mesh)
    try:  # every process holds process 0's gradients and parameters, bit for bit
        parallel.broadcast_check([*got[2].values(), *got[3].values()], "gradients or parameters")
        equal = True
    except RuntimeError:
        equal = False
    out = {"equal": equal, "mesh": (mesh.data, mesh.space, mesh.data_index, mesh.space_index)}
    if want is not None:
        out["plain"] = _step_levels(want, got)
    if mesh.data == 1:
        cases = torch.load(os.path.join(out_dir, "cases.pt"), weights_only=False)
        out["modules"] = {name: _run_module(cases["modules"][name], kind, stride, mesh)
                          for name, _, _, kind, stride in MODULES}
        out["ops"] = {name: _op_slab(cases, name, mesh) for name in OPS}
        out["dice"] = {ignore: _dice_slab(cases, ignore, mesh) for ignore in DICE_IGNORE}
        model = SemStereo(**MODEL, mesh=mesh).eval()
        model.load_state_dict(cases["eval_weights"])
        left, right = (_slab(torch.from_numpy(a), mesh, 1) for a in cases["eval_pair"])
        out["eval"] = _outputs(model, left, right)
        trainer = cli_train.main([*sys.argv[1:], "--space-parallel", str(space)])
        dump = os.path.join(out_dir, "dump_space")
        trainer.evaluate(save_dir=dump)
        out["cli"] = dict(eval=trainer.history[-1]["eval"], rows=trainer.train_loader._indices(),
                          shard=(trainer.train_loader.shard_index,
                                 trainer.train_loader.shard_count))
    torch.save(out, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _start(tmp, tag, world, argv):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), SPACE=str(SPACE), OUT_DIR=str(tmp), TAG=tag,
               PYTHONPATH=ROOT)
    code = "from tests.test_torch_space_parallel import _worker; _worker()"
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


def _write_us3d(root, n):
    """A US3D-format list of ``n`` rows at H x W (PNG views, float-TIFF
    disparity, PNG labels)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(5)
    rows = []
    for i in range(n):
        right = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
        d = int(rng.integers(-6, 7))
        Image.fromarray(np.roll(right, d, axis=1)).save(f"{root}/l{i}.png")
        Image.fromarray(right).save(f"{root}/r{i}.png")
        disp = (d + rng.uniform(-0.5, 0.5, (H, W))).astype(np.float32)
        Image.fromarray(disp, mode="F").save(f"{root}/d{i}.tif")
        Image.fromarray(rng.integers(0, 6, (H, W)).astype(np.uint8)).save(f"{root}/s{i}.png")
        rows.append(f"l{i}.png r{i}.png d{i}.tif s{i}.png")
    return rows


def _cases():
    rng = np.random.default_rng(23)
    modules = {}
    for name, xshape, f, kind, stride in MODULES:
        c, dims = xshape[-1], len(xshape) - 2
        cin = 1 if kind == "dw" else c
        f = c if kind == "dw" else f
        out = [n * 2 if kind == "deconv" else n // stride for n in xshape[1:-1]]
        k = 4 if kind == "deconv" and dims == 2 else 3
        modules[name] = dict(
            x=rng.standard_normal(xshape).astype(np.float32),
            kernel=(rng.standard_normal((*[k] * dims, cin, f)) / np.sqrt(k ** dims * cin)
                    ).astype(np.float32),
            scale=(1 + 0.1 * rng.standard_normal(f)).astype(np.float32),
            bias=(0.1 * rng.standard_normal(f)).astype(np.float32),
            gy=rng.standard_normal((xshape[0], *out, f)).astype(np.float32))
    ops = {}
    for name, (xshape, _, _) in OPS.items():
        x = torch.from_numpy(rng.standard_normal(xshape).astype(np.float32))
        module = _op_module(name)
        ops[name] = dict(x=x.numpy(), state={} if module is None else module.state_dict(),
                         gy=rng.standard_normal(_op_output_shape(name, xshape)).astype(
                             np.float32))
    logits = rng.standard_normal((2, 8, 6, 6)).astype(np.float32)
    labels = rng.integers(0, 6, (2, 8, 6)).astype(np.int64)
    return dict(modules=modules, ops=ops, dice=(logits, labels))


def _op_output_shape(name, xshape):
    if name.startswith("propagate5"):
        return (xshape[0], 5, *xshape[1:])
    if name.startswith("bilinear"):
        s = 2 if name.endswith("x2") else 4
        return (xshape[0], s * xshape[1], s * xshape[2], xshape[3])
    if name.startswith("trilinear"):
        return (xshape[0], *[2 * n for n in xshape[1:4]], xshape[4])
    return xshape


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The numpy-made inputs, the two-process (space 2) and four-process
    (data 2 x space 2) runs, the JAX eval, and the CLI's data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from semstereo_tpu.models import SemStereo as JaxSemStereo
    from semstereo_tpu.parallel import make_mesh as jax_make_mesh
    from tests.test_torch_model import _numpy_variables

    tmp = tmp_path_factory.mktemp("space")
    cases = _cases()
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
            "--device", "cpu", "--logdir", str(tmp / "space_run")]
    two, four = _start(tmp, "space2", 2, argv), _start(tmp, "data2_space2", 4, [])

    jmodel = JaxSemStereo(num_classes=6, shard_spatial=True, **MODEL)
    mesh = jax_make_mesh(data=1, disp=1, space=SPACE)
    rep = NamedSharding(mesh, PartitionSpec())
    with jax.set_mesh(mesh):
        put = jax.device_put({"params": params, "batch_stats": stats}, rep)
        jout = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
            put, jax.device_put(jnp.asarray(left), rep), jax.device_put(jnp.asarray(right), rep))
        jout = jax.tree_util.tree_map(np.asarray, jout)
    with torch.inference_mode():
        one = model(torch.from_numpy(left), torch.from_numpy(right))
    return dict(two=_wait(tmp, "space2", two), four=_wait(tmp, "data2_space2", four),
                cases=cases, argv=argv, tmp=tmp, root=root, jax_eval=jout, one_eval=one)


def _gather(parts, axis):
    return torch.cat(list(parts), axis)


def test_mesh_lays_out_data_then_space(runs):
    """rank = data_index * space + space_index, as ``make_mesh`` lays out
    devices."""
    assert [r["mesh"] for r in runs["two"]] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    assert [r["mesh"] for r in runs["four"]] == [(2, 2, d, i) for d in (0, 1) for i in (0, 1)]


@pytest.mark.parametrize("name,xshape,f,kind,stride", MODULES)
def test_haloed_module_matches_jax(runs, name, xshape, f, kind, stride):
    """(i): the module on two processes' row slabs, gathered, against the
    JAX package's module on the whole input: y, dx, and the kernel's and
    BatchNorm's gradients (summed over the processes)."""
    import jax
    import jax.numpy as jnp

    from semstereo_tpu.nn.backbone import ConvNormAct as JaxConvNormAct
    from semstereo_tpu.nn.layers import BasicConv as JaxBasicConv

    case = runs["cases"]["modules"][name]
    dims, axis = len(xshape) - 2, len(xshape) - 3
    if kind == "dw":
        jmod = JaxConvNormAct(xshape[-1], 3, stride, groups=xshape[-1])
    elif kind == "deconv":
        jmod = JaxBasicConv(f, 4 if dims == 2 else 3, 2, 1, dims=dims, deconv=True,
                            output_padding=0 if dims == 2 else 1)
    else:
        jmod = JaxBasicConv(f, 3, stride, 1, dims=dims)
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
    got = [r["modules"][name] for r in runs["two"]]
    np.testing.assert_allclose(_gather((g[0] for g in got), axis).numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_gather((g[1] for g in got), axis).numpy(), np.asarray(gx),
                               rtol=1e-4, atol=1e-4)
    back = (*range(2, dims + 2), 0, 1) if kind == "deconv" else (*range(2, dims + 2), 1, 0)
    np.testing.assert_allclose(sum(g[2] for g in got).permute(*back).numpy(),
                               np.asarray(gp["conv"]["kernel"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(g[3] for g in got).numpy(), np.asarray(gp["bn"]["scale"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(g[4] for g in got).numpy(), np.asarray(gp["bn"]["bias"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(OPS))
def test_row_slab_op_matches_the_whole(runs, name):
    """(ii): the op on two processes' row slabs, gathered, against the
    one-process op on the whole: y, dx and the parameters' gradients
    (summed over the processes); the propagations equal in the forward."""
    _, axis, y_axis = OPS[name]
    c = runs["cases"]["ops"][name]
    y, dx, grads = _run_op(name, torch.from_numpy(c["x"]), torch.from_numpy(c["gy"]),
                           c["state"])
    got = [r["ops"][name] for r in runs["two"]]
    gy = _gather((g[0] for g in got), y_axis)
    if name.startswith("propagate"):  # copies of the same values
        assert torch.equal(gy, y)
    torch.testing.assert_close(gy, y, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(_gather((g[1] for g in got), axis), dx, rtol=1e-5, atol=1e-6)
    assert set(got[0][2]) == set(grads)
    scale = max([float(g.abs().max()) for g in grads.values()], default=0.0)
    for n, want in grads.items():
        err = float((sum(g[2][n] for g in got) - want).abs().max())
        assert err <= 1e-5 * scale, (n, err, scale)


@pytest.mark.parametrize("ignore", DICE_IGNORE)
def test_dice_on_row_slabs_matches_the_whole(runs, ignore):
    """(iii): the processes' shares of the dice loss sum to the whole
    image's, and to the JAX package's; the gathered gradient is the
    whole's."""
    from semstereo_tpu.losses import dice_loss as jax_dice

    loss, grad = _dice_slab(runs["cases"], ignore)
    logits, labels = runs["cases"]["dice"]
    if ignore == 255:
        labels = np.where(labels == 5, 255, labels)
    got = [r["dice"][ignore] for r in runs["two"]]
    np.testing.assert_allclose(sum(g[0] for g in got), loss, rtol=1e-6)
    np.testing.assert_allclose(sum(g[0] for g in got), float(jax_dice(logits, labels, 6, ignore)),
                               rtol=1e-6)
    torch.testing.assert_close(_gather((g[1] for g in got), 1), grad, rtol=1e-5, atol=1e-7)


def test_space_eval_matches_jax_shard_spatial(runs):
    """(iv): the two processes' rows, gathered, against JAX's
    ``shard_spatial`` eval and the one-process port eval."""
    want, one = runs["jax_eval"], runs["one_eval"]
    got = {k: _gather((r["eval"][k] for r in runs["two"]), 1) for k in ("label_l", "disp")}
    np.testing.assert_allclose(got["label_l"].numpy(), want["label_l"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["disp"].numpy(), want["disp"][0], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["disp"].numpy(), one["disp"][0].numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("run", ["two", "four"])
def test_space_step_matches_one_process(runs, run):
    """(v) space 2 and data 2 x space 2 against one process at the global
    batch of 2 (``STEP_BOUNDS``, the differences taken in process 0); every
    process's gradients and parameters equal process 0's."""
    assert all(r["equal"] for r in runs[run])
    levels, b = runs[run][0]["plain"], STEP_BOUNDS
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


def test_space_cli_epoch_matches_one_process(runs, tmp_path, capsys):
    """(vi): ``cli.train --space-parallel 2`` loads the one process's rows
    on both processes, prints each step's losses as one process does,
    writes a checkpoint within Adam's bounds of the one-process run's; its
    eval epoch equals the one-process ``cli.evaluate`` of that checkpoint,
    and the group's ``--save-dir`` dump holds the one-process dump's
    files."""
    space_run = str(runs["tmp"] / "space_run")
    capsys.readouterr()
    one = cli_train.main([*runs["argv"][:-1], str(tmp_path / "one")])
    one_log = capsys.readouterr().out
    for r in runs["two"]:
        assert r["cli"]["shard"] == (0, 1)
        np.testing.assert_array_equal(r["cli"]["rows"], one.train_loader._indices())
    space_log = open(os.path.join(space_run, "log.log")).read()
    steps = TRAIN_ROWS // 2
    for it, (rtol, atol) in enumerate([(0.0, 1.5e-3), (0.02, 0.0)]):
        prefix = f"Epoch 0/1, Iter {it}/{steps}"
        np.testing.assert_allclose(_loss_terms(space_log, prefix), _loss_terms(one_log, prefix),
                                   rtol=rtol, atol=atol)
    sd2 = torch.load(os.path.join(space_run, "checkpoint_000000.pt"), weights_only=True)
    sd1 = torch.load(tmp_path / "one" / "checkpoint_000000.pt", weights_only=True)
    assert sd2["model"].keys() == sd1["model"].keys()
    diffs = torch.cat([(sd2["model"][n] - p).abs().ravel() for n, p in sd1["model"].items()
                       if "running_" not in n]) / LR
    assert float(diffs.max()) <= 4.003, float(diffs.max())
    assert float(diffs.median()) <= 0.25, float(diffs.median())
    dump = str(tmp_path / "dump_one")
    want = cli_evaluate.main(["--preset", "us3d_stage2", *CLI_FLAGS, "--batch-size", "2",
                              "--device", "cpu", "--datapath", runs["root"], "--testlist",
                              f"{runs['root']}/test.txt", "--loadckpt", space_run,
                              "--save-dir", dump])
    for r in runs["two"]:
        got = r["cli"]["eval"]
        assert set(got) == set(want)
        for k, v in want.items():
            tol = PIXEL_SHARE if k in ("D1", "Thres1", "Thres2", "Thres3") else 0.0
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=tol + 1e-7, err_msg=k)
    space_dump = str(runs["tmp"] / "dump_space")
    names = sorted(os.listdir(dump))
    assert names == sorted(os.listdir(space_dump)) and len(names) == TEST_ROWS
    for n in names:
        a, b = (np.asarray(Image.open(os.path.join(d, n))).astype(np.int64)
                for d in (dump, space_dump))
        assert a.shape == (H, W) and np.abs(a - b).max() <= 1, n
