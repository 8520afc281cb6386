"""One train step of the port against the JAX package's, on the CPU in fp32,
from the same weights and batch: the train forward (all four disparities,
``label_l``, ``label_r``), the loss terms, the BN running statistics after
the step, every gradient, and the Adam update against optax.

Configs: US3D stage 2 cut to the tiny size of tests/test_train_integration.py
(maxdisp 16, attention windows (1,2,2)) at 64x64, batch 2, with top-k set to
keep every plane (``topk`` = the 8 planes at /4, ``refine_topk`` = 8); the
same cut of US3D stage 1 (``att_weights_only``, whose checkpoints feed stage
2) and of WHU LRSC stage 2 (the positive range, at maxdisp 32, the least
that range takes, so again 8 planes at /4; and the LRSC loss on the
predicted left labels, ``use_lrsc_self``).  With
a hard top-k choice, a change of the weights at the level of fp32 rounding
can move a plane in or out of the top k, and the plane takes its share of
the gradient with it; two runs that round differently then differ by far
more than their rounding.  With every plane kept, no hard choice sits on
the gradient's path.

Weights come from numpy (He-normal kernels, perturbed BN statistics and
affine, x8 classifier output kernels), shaped by the JAX model's
``eval_shape``; JAX takes them as they are, the port through
``load_flax_variables``; gradients and statistics go back into the JAX tree
through ``convert_semstereo_state_dict``.  Bounds:
* loss terms rtol 1e-4; labels rtol 1e-3, atol 2e-3 (as the eval test);
  disparities median |diff| < 1e-3 px and max < 0.1 px;
* running statistics rtol = atol = 1e-4 (fp32 reductions over up to 1e5
  values, in another order);
* gradients: per top-level module, ||port - JAX|| / ||JAX|| <= 0.05.  The
  two runs differ by fp32 rounding, which the net amplifies on its way to
  the gradient; a fault in a backward (a wrong tap, flip, channel swap or
  mask) gives an error of the order of the gradient itself.  Leaves whose
  true gradient is 0 (conv biases in front of a BatchNorm) are left out:
  both sides hold rounding noise there.
"""

import collections
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semstereo_tpu.config import DataConfig as JDataConfig
from semstereo_tpu.config import LossConfig as JLossConfig
from semstereo_tpu.config import ModelConfig as JModelConfig
from semstereo_tpu.config import OptimConfig as JOptimConfig
from semstereo_tpu.config import TrainConfig as JTrainConfig
from semstereo_tpu.train.state import build_model as jbuild_model
from semstereo_tpu.train.state import build_optimizer as jbuild_optimizer
from semstereo_tpu.train.steps import make_grads_fn as jmake_grads_fn
from semstereo_tpu.utils.torch_convert import convert_semstereo_state_dict
from semstereo_tpu_torch.config import (
    DataConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from semstereo_tpu_torch import losses
from semstereo_tpu_torch.convert import load_flax_variables
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.models import SemStereo
from semstereo_tpu_torch.train import (
    TrainState,
    build_optimizer,
    init_state,
    make_eval_step,
    make_grads_fn,
    make_train_step,
)
from tests._torch_threads import two_torch_threads  # noqa: F401

H = W = 64
BATCH = 2
MODEL = dict(maxdisp=16, topk=8, refine_topk=8, att_window1=(1, 2, 2), att_window2=(1, 2, 2))
JCFG = JTrainConfig(model=JModelConfig(**MODEL), data=JDataConfig(batch_size=BATCH),
                    optim=JOptimConfig(lr=1e-3), loss=JLossConfig())
CFG = TrainConfig(model=ModelConfig(**MODEL))
GRAD_REL = 0.05


def _numpy_variables(seed, jcfg=JCFG):
    jmodel = jbuild_model(jcfg)
    dummy = jnp.zeros((BATCH, H, W, 3), jnp.float32)
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
        elif name.endswith("['bias']"):
            v = 0.05 * rng.standard_normal(shape)
        elif name.endswith("['gamma']"):
            v = 0.1 * rng.standard_normal(shape)
        elif name.endswith("['beta']"):
            v = np.full(shape, 2.0)
        else:  # kernels: He-normal over fan_out
            fan_out = int(np.prod(shape[:-2])) * shape[-1] if len(shape) > 2 else shape[-1]
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    params, stats = v["params"], v["batch_stats"]
    params["classif_att"]["conv1"]["kernel"] *= 8.0
    if "classif" in params:
        params["classif"]["conv1"]["kernel"] *= 8.0
    return params, stats


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads_against_jax(jcfg, cfg, seed):
    """One step's gradients, loss terms, outputs and BN statistics of both
    packages from the same numpy weights and synthetic batch."""
    params, stats = _numpy_variables(seed, jcfg)
    batch = SyntheticStereoDataset(BATCH, H, W, cfg.model.maxdisp,
                                   symmetric=cfg.model.symmetric).batch(0, BATCH)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jgrads, (jstats, jaux, jout, _) = jax.jit(jmake_grads_fn(jcfg))(params, stats, jbatch)

    m = cfg.model
    model = SemStereo(maxdisp=m.maxdisp, topk=m.topk, refine_topk=m.refine_topk,
                      att_window1=m.att_window1, att_window2=m.att_window2,
                      att_weights_only=m.att_weights_only, symmetric=m.symmetric).train()
    load_flax_variables(model, params, stats)
    # PyTorch's own CPU convolutions, not oneDNN's: oneDNN's rounded the
    # grouped (1, 3, 3) patch conv one of three ways from run to run of the
    # same process configuration (8 of 58 runs in pairs; disparities 0.23 or
    # 0.27 px from JAX's, and gradients 0.05-0.09 apart, against 0.064 px in
    # the rest).  Without it 10 runs of 10 gave one result, 0.072 px and
    # 0.019 from JAX's.
    with torch.backends.mkldnn.flags(enabled=False):
        aux, out, _ = make_grads_fn(cfg)(model, batch)
    sd = {n: p.grad for n, p in model.named_parameters()}
    sd.update(model.named_buffers())
    grads, new_stats, unused = convert_semstereo_state_dict(sd)
    return dict(params=params, stats_tree=stats, jgrads=_flat(jgrads), jstats=_flat(jstats),
                jaux={k: float(v) for k, v in jaux.items()},
                jout=jax.tree_util.tree_map(np.asarray, jout), grads=_flat(grads),
                stats=_flat(new_stats), unused=unused, aux={k: float(v) for k, v in aux.items()},
                out=out, jgrads_tree=jgrads)


@pytest.fixture(scope="module")
def step():
    return _grads_against_jax(JCFG, CFG, seed=3)


def _check_forward(step, n_disp, absent=(), apart=(), max_px=0.1):
    """Loss terms (but those in ``apart``, checked by the caller), outputs:
    each disparity's median |diff| < 1e-3 px, 99th percentile < 0.1 px and
    max < ``max_px``."""
    assert set(step["aux"]) == set(step["jaux"]) == {"disp_loss", "label_loss", "lrsc_loss",
                                                     "loss"} - set(absent)
    for k, v in step["jaux"].items():
        if k not in apart:
            np.testing.assert_allclose(step["aux"][k], v, rtol=1e-4, err_msg=k)
    out, jout = step["out"], step["jout"]
    assert len(out["disp"]) == len(jout["disp"]) == n_disp
    for got, want in zip(out["disp"], jout["disp"]):
        assert got.shape == want.shape
        diff = np.abs(got.numpy() - want)
        assert float(np.median(diff)) < 1e-3 and float(np.quantile(diff, 0.99)) < 0.1
        assert float(diff.max()) < max_px
    for key in ("label_l", "label_r"):
        np.testing.assert_allclose(out[key].numpy(), jout[key], rtol=1e-3, atol=2e-3)


def _check_batch_stats(step):
    assert step["unused"] == []
    assert set(step["stats"]) == set(step["jstats"])
    for path, want in step["jstats"].items():
        np.testing.assert_allclose(step["stats"][path], want, rtol=1e-4, atol=1e-4, err_msg=path)


def _check_gradients(step, min_modules):
    got, want = step["grads"], step["jgrads"]
    assert set(got) == set(want)
    total = np.sqrt(sum(float(np.sum(v ** 2)) for v in want.values()))
    err, norm = collections.defaultdict(float), collections.defaultdict(float)
    for path, w_ in want.items():
        assert got[path].shape == w_.shape, path
        if np.linalg.norm(w_) <= 1e-6 * total:  # a zero gradient (bias before a BN)
            continue
        module = path.split("']")[0][2:]
        err[module] += float(np.sum((got[path] - w_) ** 2))
        norm[module] += float(np.sum(w_ ** 2))
    rel = {m: np.sqrt(err[m] / norm[m]) for m in norm}
    assert len(rel) >= min_modules
    bad = {m: r for m, r in rel.items() if not r <= GRAD_REL}
    assert not bad, bad


def test_train_forward_matches_jax(step):
    _check_forward(step, n_disp=4)


def test_train_batch_stats_match_jax(step):
    _check_batch_stats(step)


def test_train_gradients_match_jax(step):
    _check_gradients(step, min_modules=25)


# The recipes beside US3D stage 2 that the trainer runs: (model, loss,
# dataset, train outputs, loss terms it lacks, top-level modules with a
# gradient at least, bound on any disparity's largest |diff| in px).  The
# WHU stage-2 disparities are sensitive to summation order at this size:
# the port's own output moves by up to 0.115 px between 1 and 8 intra-op
# threads (and the port against JAX by 0.078-0.179 px over 1-8 threads),
# on under 0.2 % of pixels, with every plane kept and the planes in index
# order.  So there the largest |diff| may reach 0.5 px; the median and the
# 99th percentile keep their bounds, and a fault (a wrong tap, shift or
# mask) moves most pixels by the order of the disparity itself.
RECIPES = {
    "us3d_stage1": (dict(MODEL, att_weights_only=True), {}, "us3d", 2, (), 15, 0.1),
    "whu_lrsc_stage2": (dict(MODEL, maxdisp=32),
                        dict(use_seg=False, use_lrsc=False, use_lrsc_self=True),
                        "WhuDataset", 4, ("label_loss",), 25, 0.5),
}


def _lrsc_targets(label_l, disp):
    """The LRSC CE's targets: the argmax left labels gathered at column
    trunc(clip(x - d, 0, W - 1)) (``ops.warp.lrsc_label_warp``)."""
    w = disp.shape[-1]
    xi = np.clip(np.arange(w, dtype=np.float32) - disp, 0, w - 1).astype(np.int64)
    return np.take_along_axis(np.argmax(label_l, axis=-1), xi, axis=2)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_train_step_matches_jax(recipe):
    """One step of each further recipe against JAX ``make_grads_fn``: the
    loss terms and outputs, the BN statistics and the gradients, to the
    bounds of the US3D stage-2 tests above (the WHU disparities' largest
    |diff| but, see ``RECIPES``).

    With ``use_lrsc_self`` the LRSC targets are the predicted left labels
    gathered at the truncated column x - d of the predicted disparity: a
    hard choice, which a disparity that differs by fp32 rounding flips
    where x - d lies that close to an integer (one pixel moves the term by
    about 4e-4 at this size).  So the targets may differ on at most 0.1 %
    of pixels, and the port's CE on JAX's targets is held to rtol 1e-4."""
    model_kw, loss_kw, dataset, n_disp, absent, min_modules, max_px = RECIPES[recipe]
    name = "SemStereo_WHU" if dataset == "WhuDataset" else "SemStereo"
    jcfg = JTrainConfig(model=JModelConfig(name=name, **model_kw),
                        data=JDataConfig(dataset=dataset, batch_size=BATCH),
                        optim=JOptimConfig(lr=1e-3), loss=JLossConfig(**loss_kw))
    cfg = TrainConfig(model=ModelConfig(name=name, **model_kw),
                      data=DataConfig(dataset=dataset), loss=LossConfig(**loss_kw))
    step = _grads_against_jax(jcfg, cfg, seed=5)
    apart = ("lrsc_loss", "loss") if loss_kw.get("use_lrsc_self") else ()
    _check_forward(step, n_disp=n_disp, absent=absent, apart=apart, max_px=max_px)
    if apart:
        out, jout, aux, jaux = step["out"], step["jout"], step["aux"], step["jaux"]
        want = _lrsc_targets(jout["label_l"], jout["disp"][0])
        got = _lrsc_targets(out["label_l"].numpy(), out["disp"][0].numpy())
        assert (got != want).mean() <= 1e-3
        lrsc = float(losses.cross_entropy(out["label_r"], torch.from_numpy(want)))
        np.testing.assert_allclose(lrsc, jaux["lrsc_loss"], rtol=1e-4)
        np.testing.assert_allclose(aux["loss"] - aux["lrsc_loss"] + lrsc, jaux["loss"],
                                   rtol=1e-4)
    _check_batch_stats(step)
    _check_gradients(step, min_modules=min_modules)


def test_adam_matches_optax(step):
    """Two updates from the same gradients: the port's optimizer against the
    JAX package's (optax ``adam``), bias correction included."""
    jparams, jgrads = step["params"], step["jgrads_tree"]
    tx = jbuild_optimizer(JCFG)
    model, grad_model = SemStereo(**MODEL).train(), SemStereo(**MODEL)
    load_flax_variables(model, jparams, step["stats_tree"])
    load_flax_variables(grad_model, jax.tree_util.tree_map(np.asarray, jgrads),
                        step["stats_tree"])  # the JAX gradients, in the port's layouts
    grads = dict(grad_model.named_parameters())
    opt = build_optimizer(CFG, model.parameters())

    @jax.jit
    def two_updates(p, g):
        s = tx.init(p)
        for _ in range(2):
            u, s = tx.update(g, s, p)
            p = optax.apply_updates(p, u)
        return p

    for _ in range(2):
        for n, p in model.named_parameters():
            p.grad = grads[n].detach().clone()
        opt.step()
    got = _flat(convert_semstereo_state_dict(model.state_dict())[0])
    for path, want in _flat(two_updates(jparams, jgrads)).items():
        np.testing.assert_allclose(got[path], want, rtol=1e-6, atol=1e-7, err_msg=path)


def test_grad_accum_averages_microbatches():
    """grad_accum 2 on a batch of 2 gives the mean of the two one-sample
    gradients, taken in turn with the BN statistics threaded through."""
    batch = SyntheticStereoDataset(2, 64, 64, 16).batch(0, 2)
    torch.manual_seed(0)
    model = SemStereo(**MODEL).train()
    twin = SemStereo(**MODEL).train()
    twin.load_state_dict(model.state_dict())
    make_grads_fn(CFG.replace(optim=OptimConfig(grad_accum=2)))(model, batch)
    single = make_grads_fn(CFG)
    for i in range(2):
        single(twin, {k: v[i:i + 1] for k, v in batch.items()})
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        torch.testing.assert_close(p.grad, q.grad / 2, rtol=1e-4, atol=1e-6, msg=n)
    for (n, b), c in zip(model.named_buffers(), twin.buffers()):
        torch.testing.assert_close(b, c, rtol=0, atol=0, msg=n)


@pytest.mark.parametrize("dtype,stage1", [("float32", False), ("bfloat16", True)])
def test_train_step_on_the_cpu(dtype, stage1):
    """The whole step through the port's entry points: finite losses and
    metrics, fp32 gradients and parameters that move, fp32 BN statistics
    that move, and the train outputs of the stage."""
    model_cfg = ModelConfig(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2),
                            att_weights_only=stage1)
    cfg = TrainConfig(model=model_cfg, compute_dtype=dtype,
                      optim=OptimConfig(grad_clip=1.0))
    state = init_state(cfg, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = SyntheticStereoDataset(2, 64, 64, 16).batch(0, 2)
    scalars = make_train_step(cfg)(state, batch)
    assert set(scalars) == {"disp_loss", "label_loss", "lrsc_loss", "loss", "EPE", "D1",
                            "Thres1", "Thres2", "Thres3"}
    assert all(torch.isfinite(v) for v in scalars.values())
    params = dict(state.model.named_parameters())
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all() for p in params.values())
    moved = [n for n, v in state.model.state_dict().items() if not torch.equal(v, before[n])]
    assert "feature.conv_stem.conv.weight" in moved and "chal_2.1.running_var" in moved
    assert state.model.chal_2[1].running_var.dtype == torch.float32
    ev = make_eval_step(cfg)(state, batch)
    assert ev["disp_est"].shape == (2, 64, 64) and ev["confusion"].shape == (5, 5)
    assert isinstance(state, TrainState) and not state.model.training
    out = SemStereo(**{k: getattr(model_cfg, k) for k in MODEL}, att_weights_only=stage1)\
        .train()(batch["left"], batch["right"])
    assert len(out["disp"]) == (2 if stage1 else 4)


def test_bf16_eval_after_a_train_step_uses_the_new_weights():
    """The bf16 eval step runs on casts of the master weights made anew in
    every call.  An eval after a train step must use the updated weights,
    whatever memory the new casts land in: its estimates equal those of a
    run with every module's cached eval operands dropped."""
    cfg = TrainConfig(model=ModelConfig(maxdisp=16, topk=4, att_window1=(1, 2, 2),
                                        att_window2=(1, 2, 2)), compute_dtype="bfloat16")
    state = init_state(cfg, device="cpu")
    batch = SyntheticStereoDataset(2, 64, 64, 16).batch(0, 2)
    eval_step, train_step = make_eval_step(cfg), make_train_step(cfg)
    eval_step(state, batch)
    for _ in range(2):
        train_step(state, batch)
    cached = eval_step(state, batch)
    for m in state.model.modules():
        m.__dict__.pop("_derived", None)
    fresh = eval_step(state, batch)
    for key in ("disp_est", "confusion"):
        torch.testing.assert_close(cached[key], fresh[key], rtol=0, atol=0, msg=key)


def test_init_state_runs_on_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(CFG)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter where importing ``jax`` or ``semstereo_tpu`` raises."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "semstereo_tpu"):
            raise ImportError("blocked: " + name)
for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")]:
    del sys.modules[name]
sys.meta_path.insert(0, Block())
import semstereo_tpu_torch
n = 0
for m in pkgutil.walk_packages(semstereo_tpu_torch.__path__, "semstereo_tpu_torch."):
    importlib.import_module(m.name)
    n += 1
import chip_smoke
print(n)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.split()[-1]) >= 25
