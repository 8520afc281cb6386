"""Training command line (counterpart of the JAX package's ``scripts/train.py``).

    python -m semstereo_tpu_torch.cli.train --preset us3d_stage1 --datapath ... --trainlist ...
    python -m semstereo_tpu_torch.cli.train --preset us3d_stage2 --loadckpt checkpoints/us3d_stage1
    torchrun --nproc-per-node 2 -m semstereo_tpu_torch.cli.train --preset ... --data-parallel 2

Presets carry the whole recipe (model flags, losses, data paths, learning
rate schedule, logdir); a flag given here overrides its preset's value.  It
runs on the card unless ``--device cpu`` is given.  Started by ``torchrun``
(``WORLD_SIZE`` in the environment), it joins the process group first
(NCCL on the card, gloo on the CPU) and trains data-parallel, one process
per card, ``--batch-size`` being the global batch; process 0 writes
``log.log``, the TensorBoard logs and the checkpoints.  ``--disp-parallel
N`` splits the cost volumes' planes over groups of N consecutive processes
(world = data x disp; ``--data-parallel -1`` is world / N):

    torchrun --nproc-per-node 2 -m semstereo_tpu_torch.cli.train --preset ... --disp-parallel 2

``--space-parallel N`` splits the images' rows over groups of N
consecutive processes (world = data x space; ``--data-parallel -1`` is
world / N; each process computes its slab of rows of every layer, and
``--disp-parallel`` must then stay 1):

    torchrun --nproc-per-node 2 -m semstereo_tpu_torch.cli.train --preset ... --space-parallel 2

``--remat`` and ``--pretrained-backbone`` are the model's ``remat`` and
``pretrained_backbone``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch.distributed as dist

from semstereo_tpu_torch.config import TRAIN_PRESETS, ParallelConfig, TrainConfig
from semstereo_tpu_torch.parallel import check_parallel, init_process_group, process_index
from semstereo_tpu_torch.train.trainer import Trainer
from semstereo_tpu_torch.utils import TeeLogger


def window(spec: str | None):
    """'D,H,W' -> (D, H, W); None stays None."""
    return None if spec is None else tuple(int(x) for x in spec.split(","))


def overrides(**kw) -> dict:
    """The given keyword arguments that are not None."""
    return {k: v for k, v in kw.items() if v is not None}


def parse_config(argv=None) -> tuple[TrainConfig, argparse.Namespace]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="us3d_stage2", choices=sorted(TRAIN_PRESETS))
    p.add_argument("--datapath")
    p.add_argument("--trainlist")
    p.add_argument("--testlist")
    p.add_argument("--logdir")
    p.add_argument("--loadckpt", help="checkpoint dir for a partial warm start")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--epochs", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--lrepochs")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--grad-accum", type=int, help="microbatches per optimizer step")
    p.add_argument("--grad-clip", type=float, help="global-norm gradient clip (0 = off)")
    p.add_argument("--maxdisp", type=int)
    p.add_argument("--topk", type=int, help="cost-volume top-k plane selection")
    p.add_argument("--att-window1", help="stage-1 attention window D,H,W (e.g. 1,2,2)")
    p.add_argument("--att-window2", help="stage-2 attention window D,H,W (e.g. 1,2,2)")
    p.add_argument("--test-batch-size", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--save-freq", type=int, help="epochs between checkpoints")
    p.add_argument("--num-workers", type=int)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   help="model compute precision (fp32 master parameters either way)")
    p.add_argument("--remat", nargs="?", const="full",
                   help="recompute in the backward: bare flag = 'full' (backbone + 3-D "
                   "hourglasses), or a comma-set of backbone,featup,hourglass,concat,spx")
    p.add_argument("--pretrained-backbone",
                   help="timm mobilevitv2_100 state_dict (.pth) loaded into the backbone")
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="data-parallel groups (-1: the processes started / (--disp-parallel "
                   "x --space-parallel))")
    p.add_argument("--disp-parallel", type=int, default=1,
                   help="processes that split the cost volumes' planes")
    p.add_argument("--space-parallel", type=int, default=1,
                   help="processes that split the images' rows")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = p.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    try:
        check_parallel(ParallelConfig(data=args.data_parallel, disp=args.disp_parallel,
                                      space=args.space_parallel), world)
    except ValueError as e:
        p.error(str(e))

    cfg = TRAIN_PRESETS[args.preset]
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, **overrides(
            datapath=args.datapath, trainlist=args.trainlist, testlist=args.testlist,
            batch_size=args.batch_size, test_batch_size=args.test_batch_size,
            num_workers=args.num_workers)),
        optim=dataclasses.replace(cfg.optim, **overrides(
            lr=args.lr, epochs=args.epochs, lrepochs=args.lrepochs,
            grad_accum=args.grad_accum, grad_clip=args.grad_clip)),
        model=dataclasses.replace(cfg.model, **overrides(
            maxdisp=args.maxdisp, topk=args.topk, att_window1=window(args.att_window1),
            att_window2=window(args.att_window2), pretrained_backbone=args.pretrained_backbone,
            remat=True if args.remat == "full" else args.remat)),
        parallel=dataclasses.replace(cfg.parallel, data=args.data_parallel,
                                     disp=args.disp_parallel, space=args.space_parallel),
        resume=args.resume,
        **overrides(logdir=args.logdir, loadckpt=args.loadckpt, seed=args.seed,
                    save_freq=args.save_freq, compute_dtype=args.compute_dtype),
    )
    return cfg, args


def main(argv=None) -> Trainer:
    """Trains as ``argv`` asks; returns the Trainer.  stdout is teed into
    ``<logdir>/log.log`` (by process 0) for the run and restored on return;
    a process group this call joined is left on return."""
    cfg, args = parse_config(argv)
    device = args.device
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        device = init_process_group(device)
    stdout = sys.stdout
    try:
        lead = process_index() == 0
        if lead:
            os.makedirs(cfg.logdir, exist_ok=True)
            sys.stdout = TeeLogger(os.path.join(cfg.logdir, "log.log"), stream=stdout)
        writer = None
        if args.tensorboard and lead:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(cfg.logdir)
        print(f"config: {cfg}")
        trainer = Trainer(cfg, writer=writer, device=device)
        trainer.train()
        if writer is not None:
            writer.close()
        return trainer
    finally:
        sys.stdout = stdout
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
