"""Disparity parallelism of the port on the CPU: the cost volumes' planes
split over gloo processes (``parallel.make_mesh``'s disp axis), against
the JAX package's ``shard_disp`` and against one process of the port.

Tiny US3D model at 64x64: maxdisp 32, ``topk`` = ``refine_topk`` = 16,
attention windows (1, 2, 2).  Its /8 volume has 8 planes and its /4 top-k
volume 16, so ``disp = 2`` gives slabs of 4 and 8, and every plane is kept
by both top-k stages, so no hard choice of a plane sits on the eval's or
the gradient's path.  fp32 throughout, but for one bf16 eval.

* Modules against JAX: the halo-exchanged 3x3x3 conv at stride 1 and 2 and
  the k3 s2 p1 op1 deconv, each with train BatchNorm and ReLU, on the two
  processes' slabs against the JAX package's ``BasicConv(dims=3)`` on the
  whole volume: y (rtol 1e-4, atol 1e-5; measured 2.4e-6 worst), dx and
  the kernel's and BatchNorm's gradients summed over the processes (rtol
  1e-4, atol 1e-4; measured 2.4e-6 on dx of size 4, 2.3e-5 on dw of size
  56).  The plane-slab ``gwc_volume_norm`` and its VJP against JAX's
  ``gwc_volume_norm`` and its ``jax.vjp`` with the cotangent zero outside
  the slab, symmetric and positive, slabs with and without shift 0 (rtol
  1e-5, atol 1e-6).
* (i) Eval: a two-process ``disp = 2`` eval against the JAX package's
  ``SemStereo(shard_disp=True)`` under ``make_mesh(data=1, disp=2,
  space=1)`` on the 8-device CPU mesh, from the same numpy-made weights
  (``convert.load_flax_variables``): ``label_l`` rtol 1e-4, atol 1e-4
  (measured 1.6e-5), the disparity within 2e-3 px (measured 3.2e-4 px on
  disparities of about 30, where the one-process port is 3.8e-4 px from
  JAX); and against the one-process port eval within 2e-3 px (measured
  3.9e-4).  Both processes' disparities are equal.  In bf16 each
  process's outputs equal, bit for bit, those of the one-process model
  run in that process (on the same threads, whose count changes CPU
  rounding): the split computes each plane as one process does.  Before
  the attention projected the whole gathered bottleneck from one memory
  layout, its slab's rows rounded otherwise (disparities up to 4.8 px
  apart here).
* (ii) Train step: a two-process ``disp = 2`` step against the port's
  one-process step from the same weights and batch (the one-process step
  is held against JAX in tests/test_torch_train_model.py; a JAX train step
  at this shape would be one more multi-minute compile).  The sides differ
  by summation order: slab convs on other shapes, BatchNorm statistics
  reduced over the slabs, the gathered adjoints.  Measured (disp 2 /
  data 2 x disp 2): loss terms and metrics within 4.5e-6 / 6.1e-7
  (relative; D1 and Thres1-3 also one pixel's share); running means within
  1.4e-6 / 1.2e-6 of their channel's standard deviation, variances 6.7e-6
  / 7.9e-6 (relative); the whole gradient 0.0026 / 0.0017 apart, the worst
  leaf 0.018 (``gamma``) / 0.0056; Adam's parameters 1.2e-7 / 1.2e-7.
  Bounds, with the data-parallel test's margins (tests/test_torch_parallel.py):
  loss 2e-5, means 1e-5 of the standard deviation, variances 2e-5, whole
  gradient 0.02, leaf 0.1, and Adam's parameters within 1e-6 where both
  gradients share a sign and are at least 1e-4.  Every process of a run
  holds bitwise-equal gradients and parameters after the step.
* (iii) ``data = 2 x disp = 2``, four processes, against one process at
  the same global batch of 2, with the bounds of (ii).
* (iv) ``remat="full"`` at ``disp = 2`` against ``disp = 2`` without it:
  the recomputation reruns the hourglasses' halo exchanges and gathers in
  the backward; measured bitwise equal on the CPU (loss terms, statistics
  and gradients); held to loss terms within 1e-6 relative, statistics
  bitwise, gradients within 1e-4 relative per leaf.
* (v) CLI epoch: ``cli.train --disp-parallel 2`` against the one-process
  ``cli.train``: both processes load the one process's rows, each step
  prints the one process's losses (to the 3 printed decimals, then rtol
  0.02 after an Adam step), the checkpoint's parameters are within the
  Adam bounds of tests/test_torch_parallel.py, and the eval epoch's
  results equal the one-process ``cli.evaluate`` of the same checkpoint
  within rtol 1e-5.

Each process is a subprocess with its own timeout, running ``_worker``
below with ``RANK`` and ``WORLD_SIZE`` set as ``torchrun`` sets them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from semstereo_tpu_torch.cli import evaluate as cli_evaluate
from semstereo_tpu_torch.cli import train as cli_train
from semstereo_tpu_torch.config import ModelConfig, ParallelConfig, TrainConfig
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.models import SemStereo
from semstereo_tpu_torch.nn.layers import BasicConv, ConvBn
from semstereo_tpu_torch.ops import cost_volume
from semstereo_tpu_torch.train import init_state, make_train_step
from tests._torch_threads import two_torch_threads  # noqa: F401
from tests.test_torch_parallel import _free_port, _loss_terms, _write_us3d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64
MODEL = dict(maxdisp=32, topk=16, refine_topk=16, att_window1=(1, 2, 2), att_window2=(1, 2, 2))
CLI_FLAGS = ["--maxdisp", "32", "--topk", "16", "--att-window1", "1,2,2", "--att-window2",
             "1,2,2"]
LR = 1e-3
PIXEL_SHARE = 1.0 / (S * S)
STEP_BOUNDS = dict(loss=2e-5, mean=1e-5, var=2e-5, whole=0.02, leaf=0.1, adam=1e-6)
TRAIN_ROWS, TEST_ROWS = 4, 3
TIMEOUT = 300
# The module cases: (name, x shape [B, D, H, W, C], F, stride, deconv)
MODULES = [("conv_s1", (1, 8, 6, 8, 8), 8, 1, False),
           ("conv_s2", (1, 8, 6, 8, 8), 16, 2, False),
           ("deconv", (1, 4, 3, 4, 16), 8, 2, True)]


def _cfg(disp=1, remat=False):
    return TrainConfig(model=ModelConfig(**MODEL, remat=remat),
                       parallel=ParallelConfig(disp=disp))


def _rows(data_index, data):
    """This data shard's rows of the global batch of 2."""
    batch = SyntheticStereoDataset(2, S, S, 32).batch(0, 2)
    return {k: v[data_index::data] for k, v in batch.items()}


def _step_results(cfg, batch, mesh=None):
    """(scalars, buffers, grads, params) of one train step from the seeded
    initial state."""
    state = init_state(cfg, device="cpu", mesh=mesh)
    scalars = {k: v.item() for k, v in make_train_step(cfg)(state, batch).items()}
    model = state.model
    return (scalars, {n: b.clone() for n, b in model.named_buffers()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def _port_module(stride, deconv, cin, f):
    if deconv:
        return ConvBn(cin, f, 3, 2, 1, dims=3, deconv=True, output_padding=1)
    return BasicConv(cin, f, 3, stride, 1, dims=3)


def _load_module(module, case):
    conv = module[0] if isinstance(module, ConvBn) else module.conv
    bn = module[1] if isinstance(module, ConvBn) else module.bn
    k = case["kernel"]
    layout = (3, 4, 0, 1, 2) if isinstance(conv, torch.nn.ConvTranspose3d) else (4, 3, 0, 1, 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(k.transpose(layout))))
        bn.weight.copy_(torch.from_numpy(case["scale"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))


def _module_slab(case, mesh, stride, deconv):
    """The port's module on this process's slab: (y slab, dx slab, dw,
    dscale, dbias) for the cotangent's slab."""
    x = torch.from_numpy(case["x"])
    module = _port_module(stride, deconv, x.shape[-1], case["kernel"].shape[-1]).train()
    _load_module(module, case)
    p0, n = mesh.slab(x.shape[1])
    xs = x[:, p0:p0 + n].clone().requires_grad_()
    y = module(xs, relu=True, mesh=mesh) if deconv else module(xs, mesh=mesh)
    q0, m = mesh.slab(case["gy"].shape[1])
    y.backward(torch.from_numpy(case["gy"][:, q0:q0 + m]))
    conv = module[0] if deconv else module.conv
    bn = module[1] if deconv else module.bn
    return (y.detach(), xs.grad, conv.weight.grad.clone(), bn.weight.grad.clone(),
            bn.bias.grad.clone())


def _step_levels(want, got) -> dict:
    """The differences of a step (``got``) from the one-process step
    (``want``), as ``STEP_BOUNDS`` holds them."""
    (scalars, buffers, grads, params), (s2, b2, g2, p2) = want, got
    total = sum(float(g.double().square().sum()) for g in grads.values()) ** 0.5
    leaf, zero = {}, [0.0]
    for n, g in grads.items():
        err, size = float((g2[n] - g).double().norm()), float(g.double().norm())
        if size > 1e-6 * total:
            leaf[n] = err / size
        else:  # a true gradient of 0 (a conv bias before a BatchNorm)
            zero.append(err / total)
    sure_max, step_max, held = 0.0, 0.0, 0
    for n, v in params.items():
        sure = ((torch.sign(grads[n]) == torch.sign(g2[n])) & (grads[n].abs() >= 1e-4)
                & (g2[n].abs() >= 1e-4))
        diff = (p2[n] - v).abs()
        step_max = max(step_max, float(diff.max()))
        if sure.any():
            sure_max = max(sure_max, float(diff[sure].max()))
        held += int(sure.sum())
    means = [n for n in buffers if n.endswith("running_mean")]
    return dict(
        scalars=(s2, scalars),
        mean=max(float(((b2[n] - buffers[n]).abs()
                        / buffers[n[:-len("mean")] + "var"].sqrt()).max()) for n in means),
        var=max(float(((b2[n] - v).abs() / v.abs()).max()) for n, v in buffers.items()
                if n.endswith("running_var")),
        whole=sum(float((g2[n] - g).double().square().sum())
                  for n, g in grads.items()) ** 0.5 / total,
        leaf=max(leaf.values()), leaf_worst=max(leaf, key=leaf.get), zero=max(zero),
        leaves=len(leaf), grads=len(grads), adam_step=step_max, adam_sure=sure_max,
        adam_held=held)


def _remat_levels(plain, remat) -> dict:
    """The remat step against the plain step of the same processes."""
    (s1, b1, g1, _), (s2, b2, g2, _) = plain, remat
    errs = [(float((g2[n] - v).norm()), float(v.norm())) for n, v in g1.items()]
    return dict(scalars=(s2, s1), stats_equal=all(torch.equal(b2[n], v) for n, v in b1.items()),
                grads_within=all(e <= 1e-4 * size + 1e-9 for e, size in errs),
                grad_rel=max(e / max(size, 1e-30) for e, size in errs))


def _outputs(model, left, right) -> dict:
    """The eval model's outputs (the first of a tuple) in fp32, on the pair
    cast to the model's dtype."""
    dtype = next(model.parameters()).dtype
    with torch.inference_mode():
        out = model(left.to(dtype), right.to(dtype))
    return {k: (v[0] if isinstance(v, tuple) else v).float() for k, v in out.items()}


def _worker():
    """One process of a run: ``$DISP`` processes per disp group of
    ``$WORLD_SIZE``; process 0 takes the one-process step first, before it
    joins the group.  The results (the steps' differences, not their
    tensors) go to ``$OUT_DIR/<tag>_rank<r>.pt``."""
    from semstereo_tpu_torch import parallel

    torch.set_num_threads(1)
    disp = int(os.environ["DISP"])
    want = _step_results(_cfg(), _rows(0, 1)) if os.environ["RANK"] == "0" else None
    parallel.init_process_group("cpu")
    mesh = parallel.make_mesh(-1, disp)
    rank, out_dir, tag = parallel.process_index(), os.environ["OUT_DIR"], os.environ["TAG"]
    got = _step_results(_cfg(disp), _rows(mesh.data_index, mesh.data), mesh)
    try:  # every process holds process 0's gradients and parameters, bit for bit
        parallel.broadcast_check([*got[2].values(), *got[3].values()], "gradients or parameters")
        equal = True
    except RuntimeError:
        equal = False
    out = {"equal": equal, "mesh": (mesh.data, mesh.disp, mesh.data_index, mesh.disp_index)}
    if want is not None:
        out["plain"] = _step_levels(want, got)
    if mesh.data == 1:
        out["remat"] = _remat_levels(got, _step_results(_cfg(disp, remat="full"), _rows(0, 1),
                                                        mesh))
        cases = torch.load(os.path.join(out_dir, "cases.pt"), weights_only=False)
        out["modules"] = {name: _module_slab(cases[name], mesh, stride, deconv)
                          for name, _, _, stride, deconv in MODULES}
        model = SemStereo(**MODEL, mesh=mesh).eval()
        model.load_state_dict(cases["eval_weights"])
        left, right = (torch.from_numpy(a) for a in cases["eval_pair"])
        out["eval"] = _outputs(model, left, right)
        out["eval_bf16"] = _outputs(model.to(torch.bfloat16), left, right)
        one = SemStereo(**MODEL).eval()  # one process's model, on this process's threads
        one.load_state_dict(cases["eval_weights"])
        out["one_bf16"] = _outputs(one.to(torch.bfloat16), left, right)
        trainer = cli_train.main([*sys.argv[1:], "--disp-parallel", str(disp)])
        out["cli"] = dict(eval=trainer.history[-1]["eval"], rows=trainer.train_loader._indices(),
                          shard=(trainer.train_loader.shard_index,
                                 trainer.train_loader.shard_count))
    torch.save(out, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _spawn(tmp, tag, world, disp, argv):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), DISP=str(disp), OUT_DIR=str(tmp), TAG=tag,
               PYTHONPATH=ROOT)
    code = "from tests.test_torch_disp_parallel import _worker; _worker()"
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
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
    return [torch.load(tmp / f"{tag}_rank{r}.pt", weights_only=False) for r in range(world)]


def _jax_variables(jmodel):
    """The JAX model's variables with numpy values, as tests/test_torch_model.py
    makes them."""
    from tests.test_torch_model import _numpy_variables

    return _numpy_variables(jmodel, seed=4)


def _module_cases():
    rng = np.random.default_rng(21)
    cases = {}
    for name, xshape, f, stride, deconv in MODULES:
        c = xshape[-1]
        d = xshape[1] * 2 if deconv else (xshape[1] - 1) // stride + 1
        hw = [n * 2 if deconv else (n - 1) // stride + 1 for n in xshape[2:4]]
        cases[name] = dict(
            x=rng.standard_normal(xshape).astype(np.float32),
            kernel=(rng.standard_normal((3, 3, 3, c, f)) / np.sqrt(27 * c)).astype(np.float32),
            scale=(1 + 0.1 * rng.standard_normal(f)).astype(np.float32),
            bias=(0.1 * rng.standard_normal(f)).astype(np.float32),
            gy=rng.standard_normal((xshape[0], d, *hw, f)).astype(np.float32))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The numpy-made inputs, the JAX eval, the two-process (disp 2) and
    four-process (data 2 x disp 2) runs, and the CLI's data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from semstereo_tpu.models import SemStereo as JaxSemStereo
    from semstereo_tpu.parallel import make_mesh as jax_make_mesh

    tmp = tmp_path_factory.mktemp("disp")
    cases = _module_cases()
    params, stats = _jax_variables(JaxSemStereo(num_classes=6, **MODEL))
    model = SemStereo(**MODEL).eval()
    load_flax_variables(model, params, stats)
    rng = np.random.default_rng(7)
    right = rng.standard_normal((1, S, S, 3)).astype(np.float32)
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
            "--device", "cpu", "--logdir", str(tmp / "disp_run")]
    two = _spawn(tmp, "disp2", 2, 2, argv)
    four = _spawn(tmp, "data2_disp2", 4, 2, [])

    jmodel = JaxSemStereo(num_classes=6, shard_disp=True, **MODEL)
    mesh = jax_make_mesh(data=1, disp=2, space=1)
    rep = NamedSharding(mesh, PartitionSpec())
    with jax.set_mesh(mesh):
        put = jax.device_put({"params": params, "batch_stats": stats}, rep)
        jout = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
            put, jax.device_put(jnp.asarray(left), rep), jax.device_put(jnp.asarray(right), rep))
    with torch.inference_mode():
        one = model(torch.from_numpy(left), torch.from_numpy(right))
    return dict(two=two, four=four, cases=cases, argv=argv, tmp=tmp, root=root,
                jax_eval=jax.tree_util.tree_map(np.asarray, jout), one_eval=one)


def test_mesh_lays_out_data_then_disp(runs):
    """rank = data_index * disp + disp_index, as ``make_mesh`` lays out
    devices."""
    assert [r["mesh"] for r in runs["two"]] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    assert [r["mesh"] for r in runs["four"]] == [(2, 2, d, i) for d in (0, 1) for i in (0, 1)]


@pytest.mark.parametrize("name,xshape,f,stride,deconv", MODULES)
def test_halo_exchanged_module_matches_jax(runs, name, xshape, f, stride, deconv):
    """The conv (or deconv) + train BatchNorm + ReLU on two processes'
    slabs, gathered, against the JAX package's ``BasicConv(dims=3)`` on the
    whole volume: y, dx, and the kernel's and BN's gradients (summed over
    the processes)."""
    import jax
    import jax.numpy as jnp

    from semstereo_tpu.nn.layers import BasicConv as JaxBasicConv

    case = runs["cases"][name]
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
    got = [r["modules"][name] for r in runs["two"]]
    np.testing.assert_allclose(torch.cat([g[0] for g in got], 1).numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.cat([g[1] for g in got], 1).numpy(), np.asarray(gx),
                               rtol=1e-4, atol=1e-4)
    dw = sum(g[2] for g in got)
    layout = (2, 3, 4, 0, 1) if deconv else (2, 3, 4, 1, 0)
    np.testing.assert_allclose(dw.permute(*layout).numpy(), np.asarray(gp["conv"]["kernel"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(g[3] for g in got).numpy(), np.asarray(gp["bn"]["scale"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(g[4] for g in got).numpy(), np.asarray(gp["bn"]["bias"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_shift,symmetric,p0,n", [
    (4, True, 0, 4), (4, True, 4, 4), (4, True, 2, 4), (8, False, 0, 4), (8, False, 4, 4)])
def test_plane_slab_cost_volume_matches_jax(max_shift, symmetric, p0, n):
    """The slab of ``gwc_volume_norm`` (shifts -4..-1, 0..3 and -2..1 of
    the symmetric 8-plane volume; 0..3 and 4..7 of the positive one) and
    its VJP against JAX's whole volume and its VJP with the cotangent zero
    outside the slab."""
    import jax
    import jax.numpy as jnp

    from semstereo_tpu.ops.cost_volume import gwc_volume_norm as jax_gwc

    rng = np.random.default_rng(31 + p0)
    left, right = (rng.standard_normal((1, 3, 16, 32)).astype(np.float32) for _ in range(2))
    d = cost_volume.shift_range(max_shift, symmetric)[1]
    gbar = np.zeros((1, d, 3, 16, 4), np.float32)
    gbar[:, p0:p0 + n] = rng.standard_normal((1, n, 3, 16, 4))
    vol, vjp = jax.vjp(lambda a, b: jax_gwc(a, b, max_shift, 4, symmetric=symmetric),
                       jnp.asarray(left), jnp.asarray(right))
    gl_j, gr_j = vjp(jnp.asarray(gbar))
    lt, rt = (torch.from_numpy(a).requires_grad_() for a in (left, right))
    y = cost_volume.gwc_volume_norm(lt, rt, max_shift, 4, symmetric, p0, n)
    gl, gr = torch.autograd.grad(y, (lt, rt), torch.from_numpy(gbar[:, p0:p0 + n]))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(vol)[:, p0:p0 + n], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(gl_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gr.numpy(), np.asarray(gr_j), rtol=1e-5, atol=1e-6)


def test_disp_eval_matches_jax_shard_disp(runs):
    """(i): both processes' outputs against JAX's ``shard_disp`` eval and
    the one-process port eval."""
    want, one = runs["jax_eval"], runs["one_eval"]
    for r in runs["two"]:
        got = r["eval"]
        np.testing.assert_allclose(got["label_l"].numpy(), want["label_l"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["disp"].numpy(), want["disp"][0], rtol=0, atol=2e-3)
        np.testing.assert_allclose(got["disp"].numpy(), one["disp"][0].numpy(), rtol=0,
                                   atol=2e-3)
    assert torch.equal(runs["two"][0]["eval"]["disp"], runs["two"][1]["eval"]["disp"])


def test_disp_bf16_eval_equals_one_process(runs):
    """(i) in bf16: each process's outputs equal those of the one-process
    model that it runs on the same threads, bit for bit."""
    for r in runs["two"]:
        got, one = r["eval_bf16"], r["one_bf16"]
        assert got.keys() == one.keys()
        for k, v in one.items():
            assert torch.equal(got[k], v), (k, float((got[k] - v).abs().max()))


@pytest.mark.parametrize("run", ["two", "four"])
def test_disp_step_matches_one_process(runs, run):
    """(ii) disp 2 and (iii) data 2 x disp 2 against one process at the
    global batch of 2 (``STEP_BOUNDS``; the differences are taken in process
    0, ``_step_levels``); every process's gradients and parameters equal
    process 0's."""
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


def test_remat_at_disp_matches_plain_disp(runs):
    """(iv): ``remat="full"`` recomputes the hourglasses, halo exchanges and
    gathers included, in the backward."""
    for r in runs["two"]:
        levels = r["remat"]
        got, want = levels["scalars"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
        assert levels["stats_equal"] and levels["grads_within"], levels


def test_disp_cli_epoch_matches_one_process(runs, tmp_path, capsys):
    """(v): ``cli.train --disp-parallel 2`` loads the one process's rows on
    both processes, prints each step's losses as one process does, writes
    a checkpoint within Adam's bounds of the one-process run's, and its eval
    epoch equals the one-process ``cli.evaluate`` of that checkpoint."""
    disp_run = str(runs["tmp"] / "disp_run")
    capsys.readouterr()
    one = cli_train.main([*runs["argv"][:-1], str(tmp_path / "one")])
    one_log = capsys.readouterr().out
    for r in runs["two"]:
        assert r["cli"]["shard"] == (0, 1)
        np.testing.assert_array_equal(r["cli"]["rows"], one.train_loader._indices())
    disp_log = open(os.path.join(disp_run, "log.log")).read()
    steps = TRAIN_ROWS // 2
    for it, (rtol, atol) in enumerate([(0.0, 1.5e-3), (0.02, 0.0)]):
        prefix = f"Epoch 0/1, Iter {it}/{steps}"
        np.testing.assert_allclose(_loss_terms(disp_log, prefix), _loss_terms(one_log, prefix),
                                   rtol=rtol, atol=atol)
    sd2 = torch.load(os.path.join(disp_run, "checkpoint_000000.pt"), weights_only=True)
    sd1 = torch.load(tmp_path / "one" / "checkpoint_000000.pt", weights_only=True)
    assert sd2["model"].keys() == sd1["model"].keys()
    diffs = torch.cat([(sd2["model"][n] - p).abs().ravel() for n, p in sd1["model"].items()
                       if "running_" not in n]) / LR
    assert float(diffs.max()) <= 4.003, float(diffs.max())
    assert float(diffs.median()) <= 0.25, float(diffs.median())
    want = cli_evaluate.main(["--preset", "us3d_stage2", *CLI_FLAGS, "--batch-size", "2",
                              "--device", "cpu", "--datapath", runs["root"], "--testlist",
                              f"{runs['root']}/test.txt", "--loadckpt", disp_run])
    for r in runs["two"]:
        got = r["cli"]["eval"]
        assert set(got) == set(want)
        for k, v in want.items():
            tol = PIXEL_SHARE if k in ("D1", "Thres1", "Thres2", "Thres3") else 0.0
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=tol + 1e-7, err_msg=k)
