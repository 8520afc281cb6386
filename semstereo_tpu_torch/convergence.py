"""Convergence harness: the whole training stack learns (counterpart of the
JAX package's ``benchmarks/convergence.py``).

    python -m semstereo_tpu_torch.convergence                      # on the card
    python -m semstereo_tpu_torch.convergence --device cpu --overfit-epochs 2 \
        --twostage-epochs 1 --only overfit

It drives the real command lines (``cli.train``, ``cli.evaluate``), the
on-disk US3D data layer, checkpoints and the stage-1 -> stage-2 partial
restore on learnable synthetic data (``gen_dataset``: integer-shift stereo
pairs, one constant label per pair), at the tiny model config (maxdisp 16,
topk 4, attention windows (1, 2, 2), 32x32 tiles) and full channel width:

(a) overfit: ``us3d_stage2`` from scratch, evaluated on the train list; the
    final eval must reach EPE < 1 px and mIoU > 0.95.  Run in fp32
    (``--only overfit``) and in bf16 (``--only overfit_bf16``).
(b) two_stage: ``us3d_stage1`` -> ``--loadckpt`` -> ``us3d_stage2`` ->
    ``cli.evaluate`` on a held-out list: stage 2's EPE must beat stage 1's,
    the seg and LRSC losses must fall over the two stages, the printed count
    of partially loaded tensors must be the count ``restore_partial`` gives
    for the same config, and ``cli.evaluate`` must reproduce the last
    in-training eval's EPE within 1e-4 px.
(c) bf16_vs_fp32: the tiny train step for ``--bf16-steps`` steps in fp32 and
    in bf16 from the fp32 master of each of ``BF16_SEEDS``, over the 4
    batches of the 8 synthetic samples in order; the median over the seeds
    of the bf16 tails (mean loss of the final 10 steps) must lie within
    ``TAIL_REL`` of the median fp32 tail, and every tail below
    ``FALL_TRACKS`` of its curve's first loss.

The recipe is the JAX package's: ``--seed 1``, 60 and 12 epochs,
``--lrepochs 2E/3:2``, batch 2, test batch 4, 2 loader threads.  Each
command line and each curve runs in a child process of this module
(``--child train|evaluate|curve ...``) that reports the K1-K4 launches it
made; on the card in PyTorch's deterministic mode, so that a run repeats
itself and the standalone evaluation sees the numbers the in-training one
saw.  The record goes to ``--out`` (default ``<workdir>/convergence.json``);
the exit code is 1 when any ``pass_*`` key is false.  Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--maxdisp", "16", "--topk", "4", "--att-window1", "1,2,2", "--att-window2", "1,2,2"]
# (c)'s bounds: the median bf16 tail within TAIL_REL of the median fp32 tail
# over the seeds (the JAX test's 10 %, held to the medians: the tail of one
# seed moves with the plateaus that some seeds meet in either dtype), and
# every tail below FALL_TRACKS of its first loss (the JAX harness's bound).
TAIL_REL, TAIL_STEPS, FALL_TRACKS = 0.10, 10, 0.7
BF16_SEEDS, BF16_STEPS = (1, 2, 3, 4, 5), 200
CHILD_TIMEOUT = 7200
# PyTorch's deterministic mode on the card needs cuBLAS's fixed workspace.
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def gen_dataset(root: str, n_train: int = 16, n_test: int = 4, size: int = 32,
                dmax: int = 6, seed: int = 0) -> None:
    """A learnable US3D-format dataset: right = blurred noise, left = its roll
    by one integer disparity d in [-dmax, dmax] per pair (PNG views, float
    TIFF disparity), label = one constant class per pair (PNG); the lists
    ``train.txt`` (the first ``n_train`` pairs) and ``test.txt``."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_train + n_test):
        # blurred noise gives the matcher local structure at every scale
        base = rng.uniform(0, 255, (size, size, 3))
        k = np.ones((3, 3)) / 9.0
        for c in range(3):
            base[..., c] = np.real(
                np.fft.ifft2(np.fft.fft2(base[..., c]) * np.fft.fft2(k, (size, size))))
        right = np.clip(base, 0, 255).astype(np.uint8)
        d = int(rng.integers(-dmax, dmax + 1))
        left = np.roll(right, d, axis=1)
        disp = np.full((size, size), float(d), np.float32)
        label = np.full((size, size), int(rng.integers(0, 5)), np.uint8)
        Image.fromarray(left).save(os.path.join(root, f"l{i}.png"))
        Image.fromarray(right).save(os.path.join(root, f"r{i}.png"))
        Image.fromarray(disp, mode="F").save(os.path.join(root, f"d{i}.tif"))
        Image.fromarray(label).save(os.path.join(root, f"s{i}.png"))
        rows.append(f"l{i}.png r{i}.png d{i}.tif s{i}.png")
    for name, part in (("train", rows[:n_train]), ("test", rows[n_train:])):
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(part) + "\n")


_NUM = r"([-\d.eE+]+|nan|inf)"
_ITER_RE = re.compile(
    rf"Epoch (\d+)/\d+, Iter (\d+)/\d+, loss = {_NUM}, disp = {_NUM}"
    rf"(?:, seg = {_NUM})?(?:, lrsc = {_NUM})?(?:, time = {_NUM})?")


def parse_log(text: str) -> tuple[list[dict], list[dict]]:
    """``cli.train``'s printed log -> (one dict per train step: epoch, iter,
    loss, disp_loss and, where printed, seg, lrsc and the step's time; one
    dict per ``avg_test_scalars`` line)."""
    iters = []
    for m in _ITER_RE.finditer(text):
        rec = {"epoch": int(m.group(1)), "iter": int(m.group(2)),
               "loss": float(m.group(3)), "disp_loss": float(m.group(4))}
        for key, group in (("seg", 5), ("lrsc", 6), ("time", 7)):
            if m.group(group) is not None:
                rec[key] = float(m.group(group))
        iters.append(rec)
    evals = []
    for line in text.splitlines():
        if line.startswith("avg_test_scalars"):
            # the dict's repr may hold np.float64(...) and nan
            d = eval(line.split(" ", 1)[1],
                     {"__builtins__": {}, "nan": float("nan"), "inf": float("inf"), "np": np})
            evals.append({k: float(v) for k, v in d.items()})
    return iters, evals


def epoch_means(iters: list[dict], key: str) -> dict:
    out = {}
    for r in iters:
        if key in r:
            out.setdefault(r["epoch"], []).append(r[key])
    return {e: float(np.mean(v)) for e, v in sorted(out.items())}


def thin(curve: dict, keep: int = 30) -> dict:
    ks = list(curve)
    sel = ks[::max(1, len(ks) // keep)]
    if ks and ks[-1] not in sel:
        sel.append(ks[-1])
    return {k: curve[k] for k in sel}


def _child_cmd(kind: str, out: str, args: list[str]) -> list[str]:
    return [sys.executable, "-m", "semstereo_tpu_torch.convergence", "--child", kind, out, *args]


def _child_env(device: str) -> dict:
    return dict(os.environ, **(DETERMINISTIC_ENV if device != "cpu" else {}))


def run_cli(kind: str, args: list[str], device: str) -> tuple[str, dict]:
    """``cli.train.main(args)`` (``kind`` "train") or ``cli.evaluate.main``
    ("evaluate") in a child process; returns (its printed output, the
    kernel launches it made)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "launches.json")
        cmd = _child_cmd(kind, out, [*args, "--device", device])
        print("+", " ".join(cmd[1:]), flush=True)
        proc = subprocess.run(cmd, cwd=REPO, env=_child_env(device), text=True,
                              capture_output=True, timeout=CHILD_TIMEOUT)
        sys.stdout.write(proc.stdout[-2000:])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-8000:])
            raise RuntimeError(f"cli.{kind} {args} failed, exit {proc.returncode}")
        with open(out) as f:
            return proc.stdout, json.load(f)


def _fresh(logdir: str) -> str:
    """An empty ``logdir``: a checkpoint of an earlier run left there would be
    restored by ``--loadckpt`` in its place."""
    shutil.rmtree(logdir, ignore_errors=True)
    return logdir


def _recipe(root: str, testlist: str, epochs: int) -> list[str]:
    return ["--datapath", root, "--trainlist", os.path.join(root, "train.txt"),
            "--testlist", os.path.join(root, testlist),
            "--epochs", str(epochs), "--lrepochs", f"{2 * epochs // 3}:2",
            "--batch-size", "2", "--test-batch-size", "4", "--num-workers", "2",
            "--save-freq", str(epochs), "--seed", "1", *TINY]


def overfit(root: str, workdir: str, epochs: int, dtype: str = "float32",
            device: str = "cuda") -> dict:
    """(a): ``us3d_stage2`` from scratch in ``dtype``, evaluated on the train
    list (memorizing it is the point): EPE < 1 px and mIoU > 0.95 at the
    end."""
    logdir = _fresh(os.path.join(workdir, f"overfit_{dtype}"))
    t0 = time.perf_counter()
    out, launches = run_cli("train", ["--preset", "us3d_stage2", "--logdir", logdir,
                                      "--compute-dtype", dtype,
                                      *_recipe(root, "train.txt", epochs)], device)
    iters, evals = parse_log(out)
    if not evals:
        raise RuntimeError("no eval records parsed from the overfit run")
    final = evals[-1]
    rec = {
        "compute_dtype": dtype,
        "epochs": epochs,
        "steps": len(iters),
        "wall_s": time.perf_counter() - t0,
        "launches": launches,
        "loss_curve_by_epoch": thin(epoch_means(iters, "loss")),
        "train_eval_epe_by_epoch": thin({i: e["EPE"] for i, e in enumerate(evals)
                                         if "EPE" in e}),
        "final": {k: final.get(k) for k in ("EPE", "D1", "Thres1", "mIoU", "PA")},
        "pass_epe_lt_1px": bool(final["EPE"] < 1.0),
        "pass_miou_gt_0.95": bool(final["mIoU"] > 0.95),
    }
    print(f"overfit {dtype}:", json.dumps(rec["final"]), flush=True)
    return rec


def expected_restore_count(stage1_logdir: str) -> int:
    """The tensors ``restore_partial`` loads from the stage-1 checkpoint into
    a fresh tiny ``us3d_stage2`` state on the CPU."""
    from semstereo_tpu_torch.config import TRAIN_PRESETS
    from semstereo_tpu_torch.train import checkpoint as ckpt
    from semstereo_tpu_torch.train import init_state

    cfg = TRAIN_PRESETS["us3d_stage2"].replace(model=tiny_config("float32", 1).model)
    return ckpt.restore_partial(stage1_logdir, init_state(cfg, device="cpu"))[1]


def two_stage(root: str, workdir: str, epochs: int, device: str = "cuda") -> dict:
    """(b): stage 1 -> partial restore -> stage 2 -> ``cli.evaluate``, on the
    held-out test list."""
    log1 = _fresh(os.path.join(workdir, "stage1"))
    log2 = _fresh(os.path.join(workdir, "stage2"))
    common = _recipe(root, "test.txt", epochs)
    t0 = time.perf_counter()
    out1, launches1 = run_cli("train", ["--preset", "us3d_stage1", "--logdir", log1, *common],
                              device)
    iters1, evals1 = parse_log(out1)
    out2, launches2 = run_cli("train", ["--preset", "us3d_stage2", "--logdir", log2,
                                        "--loadckpt", log1, *common], device)
    iters2, evals2 = parse_log(out2)
    n_loaded = re.search(r"partially loaded (\d+) tensors", out2)
    # the standalone evaluator on stage 2's checkpoint reproduces its last
    # in-training eval
    oute, launches_e = run_cli("evaluate", [
        "--preset", "us3d_stage2", *TINY, "--datapath", root,
        "--testlist", os.path.join(root, "test.txt"), "--loadckpt", log2,
        "--batch-size", "4"], device)
    _, evals_e = parse_log(oute)
    epe1, epe2 = evals1[-1]["EPE"], evals2[-1]["EPE"]
    # the seg and LRSC trends over the whole recipe (stage 1 trains the seg
    # head too: att_weights_only only switches the disparity branch), since
    # short stages oscillate from epoch to epoch
    seg = [*epoch_means(iters1, "seg").values(), *epoch_means(iters2, "seg").values()]
    lrsc = [*epoch_means(iters1, "lrsc").values(), *epoch_means(iters2, "lrsc").values()]
    expected = expected_restore_count(log1)
    loaded = int(n_loaded.group(1)) if n_loaded else None
    standalone = float(evals_e[-1]["EPE"]) if evals_e else None
    rec = {
        "epochs_per_stage": epochs,
        "wall_s": time.perf_counter() - t0,
        "launches": {"stage1": launches1, "stage2": launches2, "evaluate": launches_e},
        "stage1_final_eval": {k: evals1[-1].get(k) for k in ("EPE", "D1", "mIoU")},
        "stage2_final_eval": {k: evals2[-1].get(k) for k in ("EPE", "D1", "mIoU")},
        "standalone_eval_epe": standalone,
        "partial_restore_tensors": loaded,
        "partial_restore_expected": expected,
        "seg_loss_by_epoch": [round(v, 3) for v in seg],
        "lrsc_loss_by_epoch": [round(v, 3) for v in lrsc],
        "pass_stage2_beats_stage1_epe": bool(epe2 < epe1),
        "pass_seg_loss_decreases": bool(seg[-1] < seg[0]),
        "pass_lrsc_loss_decreases": bool(lrsc[-1] < lrsc[0]),
        "pass_partial_restore_count": bool(loaded == expected),
        "pass_standalone_eval_matches": bool(standalone is not None
                                             and abs(standalone - epe2) < 1e-4),
    }
    print("two_stage:", json.dumps({k: v for k, v in rec.items() if k != "launches"}),
          flush=True)
    return rec


def tiny_config(dtype: str, seed: int):
    """The JAX package's tiny training config (tests/test_train_integration.py:
    maxdisp 16, topk 4, windows (1, 2, 2), batch 2, lr 1e-3, seg and LRSC
    losses) in ``dtype``, its fp32 master seeded by ``seed``."""
    from semstereo_tpu_torch.config import (
        DataConfig,
        LossConfig,
        ModelConfig,
        OptimConfig,
        TrainConfig,
    )

    return TrainConfig(model=ModelConfig(maxdisp=16, topk=4, att_window1=(1, 2, 2),
                                         att_window2=(1, 2, 2)),
                       data=DataConfig(batch_size=2), optim=OptimConfig(lr=1e-3),
                       loss=LossConfig(use_seg=True, use_lrsc=True), compute_dtype=dtype,
                       seed=seed)


def curve_batches(device: str) -> list:
    """The 4 batches of 2 of the 8 synthetic 32x32 samples, in order (the JAX
    test's loader without shuffling), on ``device``."""
    from semstereo_tpu_torch.data import SyntheticStereoDataset

    ds = SyntheticStereoDataset(8, 32, 32, 16)
    return [ds.batch(i, 2, device) for i in range(0, len(ds), 2)]


CURVE_KEYS = ("loss", "disp_loss", "label_loss", "lrsc_loss", "EPE")


def curve(dtype: str, seed: int, steps: int, device: str) -> dict:
    """``steps`` train steps of ``tiny_config(dtype, seed)`` over
    ``curve_batches`` in turn: each of ``CURVE_KEYS`` per step, the
    wall time and the kernel launches."""
    import torch

    from semstereo_tpu_torch import ops
    from semstereo_tpu_torch.train import init_state, make_train_step

    cfg = tiny_config(dtype, seed)
    batches = curve_batches(device)
    state = init_state(cfg, device=device)
    step = make_train_step(cfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = {k: [] for k in CURVE_KEYS}
    for i in range(steps):
        scalars = step(state, batches[i % len(batches)])
        for k, v in zip(CURVE_KEYS, torch.stack([scalars[k].float() for k in CURVE_KEYS]).tolist()):
            rec[k].append(v)
    rec.update(s=time.perf_counter() - t0, launches=ops.launch_counts())
    return rec


def run_curves(runs: list[tuple[str, int]], steps: int, device: str) -> list[dict]:
    """One ``curve`` per (dtype, seed) of ``runs``, each a child process, all
    at once; returns them in order."""
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"{i}.json") for i in range(len(runs))]
        procs = [subprocess.Popen(_child_cmd("curve", out, [dtype, str(seed), str(steps), device]),
                                  cwd=REPO, env=_child_env(device), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for out, (dtype, seed) in zip(outs, runs)]
        try:
            texts = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for (dtype, seed), p, text in zip(runs, procs, texts):
            if p.returncode != 0:
                raise RuntimeError(f"curve {dtype} seed {seed} exited {p.returncode}:\n"
                                   f"{text[-3000:]}")
        result = []
        for out in outs:
            with open(out) as f:
                result.append(json.load(f))
        return result


def tail(losses: list[float]) -> float:
    return statistics.mean(losses[-TAIL_STEPS:])


def tail_verdict(fp32: list[list[float]], bf16: list[list[float]]) -> dict:
    """(c)'s verdict on loss curves in fp32 and bf16, one pair per seed."""
    tails = {dt: [tail(c) for c in curves] for dt, curves in (("fp32", fp32), ("bf16", bf16))}
    ratio = statistics.median(tails["bf16"]) / statistics.median(tails["fp32"])
    falls = [tail(c) / c[0] for c in [*fp32, *bf16]]
    return {
        "tails_fp32": tails["fp32"], "tails_bf16": tails["bf16"],
        "tail_ratio_per_seed": [b / f for f, b in zip(tails["fp32"], tails["bf16"])],
        "median_tail_ratio_bf16_over_fp32": ratio,
        "falls": falls,
        "pass_bf16_tracks_fp32": bool(abs(ratio - 1.0) < TAIL_REL),
        "pass_both_decrease": bool(all(np.isfinite(falls)) and max(falls) < FALL_TRACKS),
    }


def bf16_ab(seeds, steps: int, device: str = "cuda") -> dict:
    """(c): fp32 against bf16 from each seed's fp32 master, the same
    batches (every curve a child process, all at once)."""
    t0 = time.perf_counter()
    runs = [(dt, s) for s in seeds for dt in ("float32", "bfloat16")]
    curves = run_curves(runs, steps, device)
    fp32, bf16 = ([c["loss"] for (dt, _), c in zip(runs, curves) if dt == want]
                  for want in ("float32", "bfloat16"))
    rec = {"seeds": list(seeds), "steps": steps, "wall_s": time.perf_counter() - t0,
           **tail_verdict(fp32, bf16),
           "curves": {f"{dt}_seed{s}": {k: [round(v, 4) for v in c[k]] for k in CURVE_KEYS}
                      for (dt, s), c in zip(runs, curves)}}
    print("bf16_ab:", json.dumps({k: v for k, v in rec.items() if k != "curves"}), flush=True)
    return rec


def child(argv: list[str]) -> int:
    """``--child train|evaluate OUT CLI-ARGS... --device DEVICE``: the command
    line, then its kernel launches to OUT; ``--child curve OUT DTYPE SEED
    STEPS DEVICE``: one ``curve`` to OUT.  The last argument is the device;
    on the card the child runs in PyTorch's deterministic mode, its fp32
    convs and matmuls in fp32 (not TF32)."""
    import torch

    from semstereo_tpu_torch import ops

    kind, out, args = argv[0], argv[1], argv[2:]
    if args[-1] != "cpu":
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "curve":
        result = curve(args[0], int(args[1]), int(args[2]), args[3])
    else:
        from semstereo_tpu_torch.cli import evaluate, train

        ops.reset_launch_counts()
        (train.main if kind == "train" else evaluate.main)(args)
        result = ops.launch_counts()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


RUNS = ("overfit", "overfit_bf16", "twostage", "bf16")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                     "semstereo_torch_convergence"))
    p.add_argument("--out", help="record file (default <workdir>/convergence.json)")
    p.add_argument("--overfit-epochs", type=int, default=60)
    p.add_argument("--twostage-epochs", type=int, default=12)
    p.add_argument("--bf16-steps", type=int, default=BF16_STEPS)
    p.add_argument("--only", choices=RUNS, action="append",
                   help="run this experiment (repeatable; default: all)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = p.parse_args(argv)
    only = args.only or RUNS

    os.makedirs(args.workdir, exist_ok=True)
    root = os.path.join(args.workdir, "data")
    gen_dataset(root)
    conv = {}
    if "overfit" in only:
        conv["overfit"] = overfit(root, args.workdir, args.overfit_epochs, "float32", args.device)
    if "overfit_bf16" in only:
        conv["overfit_bf16"] = overfit(root, args.workdir, args.overfit_epochs, "bfloat16",
                                       args.device)
    if "twostage" in only:
        conv["two_stage"] = two_stage(root, args.workdir, args.twostage_epochs, args.device)
    if "bf16" in only:
        conv["bf16_vs_fp32"] = bf16_ab(BF16_SEEDS, args.bf16_steps, args.device)
    out = args.out or os.path.join(args.workdir, "convergence.json")
    with open(out, "w") as f:
        json.dump({"convergence": conv}, f, indent=1)
    print(f"wrote {out}")
    fails = [f"{name}.{k}" for name, sec in conv.items() for k, v in sec.items()
             if k.startswith("pass_") and not v]
    if fails:
        print("FAILED:", fails)
        return 1
    print("all convergence checks pass")
    return 0


if __name__ == "__main__":
    sys.exit(child(sys.argv[2:]) if sys.argv[1:2] == ["--child"] else main())
