r"""Evaluation command line (counterpart of the JAX package's
``scripts/evaluate.py``).

    python -m semstereo_tpu_torch.cli.evaluate --preset us3d_stage2 \
        --loadckpt checkpoints/us3d_stage2

Restores the latest checkpoint of ``--loadckpt`` whole and evaluates the
preset's test list; runs on the card unless ``--device cpu`` is given.
Started by ``torchrun`` (``WORLD_SIZE`` in the environment), it joins the
process group first, as ``cli.train`` does, and evaluates over every
process: ``--data-parallel`` (default -1, the processes that the other two
axes leave, as the JAX package's evaluation takes every device),
``--disp-parallel`` and ``--space-parallel`` are ``cli.train``'s, and
``--batch-size`` is the global test batch:

    torchrun --nproc-per-node 4 -m semstereo_tpu_torch.cli.evaluate --preset ... \
        --loadckpt ... --disp-parallel 2 --space-parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch.distributed as dist

from semstereo_tpu_torch.cli.train import overrides, window
from semstereo_tpu_torch.config import TRAIN_PRESETS, ParallelConfig
from semstereo_tpu_torch.parallel import check_parallel, init_process_group
from semstereo_tpu_torch.train import checkpoint as ckpt
from semstereo_tpu_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    """Evaluates as ``argv`` asks; returns the results dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="us3d_stage2", choices=sorted(TRAIN_PRESETS))
    p.add_argument("--datapath")
    p.add_argument("--testlist")
    p.add_argument("--loadckpt", required=True)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--maxdisp", type=int, help="must match the checkpoint's training maxdisp")
    p.add_argument("--topk", type=int, help="must match the training topk")
    p.add_argument("--att-window1", help="must match training (D,H,W e.g. 1,2,2)")
    p.add_argument("--att-window2", help="must match training (D,H,W e.g. 1,2,2)")
    p.add_argument("--eval-seg-per-batch", action="store_true",
                   help="average seg metrics per batch (NaN-skipping) instead of over "
                   "one confusion matrix")
    p.add_argument("--save-dir",
                   help="dump per-sample disparity (256*uint16 PNG) and label maps here; "
                   "works on test lists without ground truth (inference only)")
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="data-parallel groups (-1: the processes started / (--disp-parallel "
                   "x --space-parallel))")
    p.add_argument("--disp-parallel", type=int, default=1,
                   help="processes that split the cost volumes' planes")
    p.add_argument("--space-parallel", type=int, default=1,
                   help="processes that split the images' rows")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = p.parse_args(argv)
    parallel = ParallelConfig(data=args.data_parallel, disp=args.disp_parallel,
                              space=args.space_parallel)
    try:
        check_parallel(parallel, int(os.environ.get("WORLD_SIZE", "1")))
    except ValueError as e:
        p.error(str(e))

    cfg = TRAIN_PRESETS[args.preset]
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, **overrides(
            datapath=args.datapath, testlist=args.testlist, test_batch_size=args.batch_size)),
        model=dataclasses.replace(cfg.model, **overrides(
            maxdisp=args.maxdisp, topk=args.topk, att_window1=window(args.att_window1),
            att_window2=window(args.att_window2))),
        parallel=dataclasses.replace(cfg.parallel, data=args.data_parallel,
                                     disp=args.disp_parallel, space=args.space_parallel),
        **({"eval_seg_per_batch": True} if args.eval_seg_per_batch else {}),
    )
    device = args.device
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        device = init_process_group(device)
    try:
        trainer = Trainer(cfg, device=device)
        if trainer.eval_loader is None:
            raise FileNotFoundError(f"test list not found: {cfg.data.testlist}")
        trainer.initialize()
        trainer.state = ckpt.restore_checkpoint(args.loadckpt, trainer.state)
        results = trainer.evaluate(save_dir=args.save_dir)
        print(results)
        return results
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
