"""Trainer: epoch loop, learning-rate schedule, eval with meters,
checkpoints, TensorBoard logs (counterpart of
``semstereo_tpu/train/trainer.py``), in one process or, data-parallel, in
one process per shard of the batch (``parallel.py``).

The loaders yield numpy batches; the keys a step reads go to the device
(from pinned memory, without blocking, on the card) and the host metadata
(``left_filename``, ``top_pad``, ``right_pad``) stays on the host.

Data parallelism: ``batch_size`` and ``test_batch_size`` are global, as
the reference's ``nn.DataParallel`` takes them (the JAX package's are per
host): each of the N processes loads ``batch_size / N`` rows of the shard
``idx[rank::N]`` of the epoch's permutation cut to whole global batches,
which with the loader's seeding makes step s of N processes see the samples
of step s of one, and every process take ``len(train list) // batch_size``
steps.  Every process starts from the
same weights (checked by a broadcast), takes the same steps (global losses,
summed gradients) and so holds the same state; process 0 writes the
checkpoints, after which all wait at a barrier.  The eval list is sharded
the same way; a process whose shard runs out first runs alignment-only
steps (every row invalid) so that the collectives stay in step.

Eval metering differs from JAX's.  Each eval step returns the global
batch's scalars on every process.  JAX meters them on every host except on
its alignment-only steps and then sums the meters over the hosts
(``reduce_eval_meters``), so the steps before a host ran out weigh more
than the last one.  The port meters every step's global scalars on every
process, so each holds the one-process mean and no meter is reduced.  The
confusion matrix over the list is the sum of each process's matrix over its
rows, summed once after the last step; with ``eval_seg_per_batch`` each
step's matrix is summed over the processes before it is metered.

Disparity parallelism (``cfg.parallel.disp`` above 1, ``parallel.make_mesh``):
the processes form ``data`` groups of ``disp``; the processes of a group
load the same rows (the loader deals by data index over the data count),
and the batch sizes split over the data count.  The confusion matrices are
summed over one process of each group (the others add zeros), so the
printed matrix is the one-process matrix; the group's first process writes
the ``--save-dir`` dumps of its rows.

Spatial parallelism (``cfg.parallel.space`` above 1): the processes form
``data`` groups of ``space``; the processes of a group load the same rows,
as under disp, and each moves its slab of rows of every key in
``parallel.SPATIAL_KEYS`` to the device (``parallel.slab_rows``).  The
confusion matrices are summed over every process, as each counts its own
pixels.  For the ``--save-dir`` dumps the disparity (and label) rows are
gathered over the group and the group's first process writes them, the
files of one process; the TensorBoard image panel shows the logging
process's slab of rows.

Both (``disp`` and ``space`` above 1): the ``disp x space`` processes of
a data group load the same rows and each keeps its slab of them.  The
confusion matrices are counted by the processes of disp index 0, one for
each row slab; the dumps are gathered over each space group and written by
the process of disp index 0 and space index 0.
"""

from __future__ import annotations

import inspect
import os
import time
from typing import Optional

import numpy as np
import torch

from semstereo_tpu_torch.config import TrainConfig
from semstereo_tpu_torch.data import DataLoader, __datasets__
from semstereo_tpu_torch.data.loader import collate
from semstereo_tpu_torch.metrics import SegmentationMeter
from semstereo_tpu_torch.parallel import (
    all_reduce_sum_tree,
    barrier,
    broadcast_check,
    check_parallel,
    gather_rows,
    make_mesh,
    process_count,
    slab_rows,
)
from semstereo_tpu_torch.train import checkpoint as ckpt
from semstereo_tpu_torch.train.state import TrainState, init_state, set_learning_rate
from semstereo_tpu_torch.train.steps import make_eval_step, make_train_step
from semstereo_tpu_torch.utils import (
    AverageMeterDict,
    AverageMeterDictPerKey,
    save_scalars,
)

# Keys the steps consume (everything else in a sample is host metadata).
_TRAIN_KEYS = ("left", "right", "disparity", "disparity_4", "label")
_EVAL_KEYS = ("left", "right", "disparity", "label")


def _seg_scalars(cm, num_classes: int) -> dict:
    """Seg metrics of ONE batch's confusion matrix (NaN for classes absent
    from the batch; the per-key meter skips those): the per-batch
    aggregation unit of ``eval_seg_per_batch``."""
    m = SegmentationMeter(num_classes)
    m.add_confusion(cm)
    cpa, iou = m.class_pixel_accuracy(), m.iou()
    return {
        "PA": float(m.pixel_accuracy()),
        "MPA": float(m.mean_pixel_accuracy()),
        "mIoU": float(m.mean_iou()),
        **{f"CPA{i}": float(cpa[i]) for i in range(len(cpa))},
        **{f"IoU{i}": float(iou[i]) for i in range(len(iou))},
    }


def _pad_eval_batch(batch, bs, maxdisp, ignore_index, invalidate_all=False):
    """Pad a ragged eval batch to ``bs`` rows, so every eval step sees one
    shape.  Padded rows repeat the last real sample's images and carry
    all-invalid ground truth (disparity = maxdisp, outside both valid
    ranges; label = ignore_index), so the masked metrics and the confusion
    matrix give them no weight.  With ``invalidate_all`` every row is
    invalid (an alignment-only batch for a process whose eval shard ran
    out first).  Returns (padded batch, number of real rows)."""
    b0 = next(v.shape[0] for v in batch.values() if not isinstance(v, list))
    real = 0 if invalidate_all else b0
    if b0 == bs and real == b0:
        return batch, real
    pad = bs - b0
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = list(v) + [v[-1]] * pad
        else:
            v = np.asarray(v)
            out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) if pad else v.copy()
    for k, v in out.items():
        if isinstance(v, list):
            continue
        if k.startswith("disparity"):
            v[real:] = float(maxdisp)
        elif k.startswith("label"):
            v[real:] = float(ignore_index)
    return out, real


def _device_batch(batch: dict, keys, device: torch.device, mesh=None) -> dict:
    """The step's keys of a numpy batch as tensors on ``device`` (this
    process's slab of rows of each under a ``mesh`` that splits the rows):
    from pinned memory without blocking on the card."""
    batch = slab_rows({k: batch[k] for k in keys if k in batch}, mesh)
    out = {}
    for k in keys:
        if k in batch:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
    return out


def _scalar_floats(scalars: dict) -> dict:
    """0-d tensors to Python floats in one transfer from the device."""
    keys = [k for k, v in scalars.items() if v.dim() == 0]
    vals = torch.stack([scalars[k].float() for k in keys]).tolist()
    return dict(zip(keys, vals))


class Trainer:
    """``history`` keeps one record per epoch: its train wall time
    (``train_s``, loader waits included), each step's time (``step_s``,
    from the batch in hand to its scalars on the host), and the eval
    epoch's wall time (``eval_s``) and results (``eval``)."""

    def __init__(self, cfg: TrainConfig, train_dataset=None, eval_dataset=None, writer=None,
                 device="cuda"):
        world = process_count()
        launched = int(os.environ.get("WORLD_SIZE", "1"))
        if world == 1 and launched > 1:
            raise RuntimeError(
                f"WORLD_SIZE={launched} but this process is in a group of 1: join the group "
                "first (parallel.init_process_group, as cli.train does under torchrun)")
        check_parallel(cfg.parallel, world, cfg.model)
        self.mesh = make_mesh(cfg.parallel.data, cfg.parallel.disp, cfg.parallel.space)
        data = self.mesh.data
        for name in ("batch_size", "test_batch_size"):
            if getattr(cfg.data, name) % data:
                raise ValueError(f"{name}={getattr(cfg.data, name)} is the global batch; it "
                                 f"does not split over {data} data-parallel processes")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.writer = writer

        def build_dataset(list_file, training):
            ds_cls = __datasets__[cfg.data.dataset]
            kwargs = {}
            if cfg.data.crop_size is not None and \
                    "crop_size" in inspect.signature(ds_cls.__init__).parameters:
                kwargs["crop_size"] = cfg.data.crop_size
            return ds_cls(cfg.data.datapath, list_file, training, **kwargs)

        if train_dataset is None and cfg.data.trainlist and os.path.exists(cfg.data.trainlist):
            train_dataset = build_dataset(cfg.data.trainlist, True)
        if eval_dataset is None and cfg.data.testlist and os.path.exists(cfg.data.testlist):
            eval_dataset = build_dataset(cfg.data.testlist, False)

        shard = (self.mesh.data_index, data)
        self.train_loader = DataLoader(
            train_dataset, cfg.data.batch_size // data, shuffle=True,
            num_workers=cfg.data.num_workers, drop_last=True, seed=cfg.seed, shard=shard,
            prefetch=cfg.data.prefetch,
        ) if train_dataset is not None else None
        self.eval_loader = DataLoader(
            eval_dataset, cfg.data.test_batch_size // data, shuffle=False,
            num_workers=cfg.data.num_workers, drop_last=False, seed=cfg.seed, shard=shard,
            prefetch=cfg.data.prefetch,
        ) if eval_dataset is not None else None

        self.train_step = make_train_step(cfg)
        self.eval_step = make_eval_step(cfg)
        self.state: Optional[TrainState] = None
        self.history: list[dict] = []
        self._dump_index = 0

    # -- state management ---------------------------------------------------
    def initialize(self) -> TrainState:
        """A fresh state from ``cfg.seed``; then a resume from ``cfg.logdir``
        when ``cfg.resume`` is set and it holds a checkpoint, else a partial
        load from ``cfg.loadckpt`` when one is named.  Every process must
        then hold process 0's weights and statistics."""
        cfg = self.cfg
        self.state = init_state(cfg, device=self.device, mesh=self.mesh)
        if cfg.resume and ckpt.latest_epoch(cfg.logdir) is not None:
            self.state = ckpt.restore_checkpoint(cfg.logdir, self.state)
            print(f"resumed from {cfg.logdir} at epoch {self.state.epoch}")
        elif cfg.loadckpt:
            self.state, n = ckpt.restore_partial(cfg.loadckpt, self.state)
            print(f"partially loaded {n} tensors from {cfg.loadckpt}")
        broadcast_check(self.state.model.state_dict().values(), "initial weights")
        return self.state

    # -- loops --------------------------------------------------------------
    def train(self) -> TrainState:
        cfg = self.cfg
        if self.train_loader is None:
            raise FileNotFoundError(f"train list not found: {cfg.data.trainlist}")
        if self.state is None:
            self.initialize()
        os.makedirs(cfg.logdir, exist_ok=True)
        for epoch in range(int(self.state.epoch), cfg.optim.epochs):
            record = dict(epoch=epoch, step_s=[])
            t_epoch = time.perf_counter()
            self.state = set_learning_rate(self.state, cfg, epoch)
            self.train_loader.set_epoch(epoch)
            for it, batch in enumerate(self.train_loader):
                t0 = time.time()
                dev_batch = _device_batch(batch, _TRAIN_KEYS, self.device, self.mesh)
                scalars = _scalar_floats(self.train_step(self.state, dev_batch))
                step = epoch * len(self.train_loader) + it
                if self.writer and step % (cfg.summary_freq * 1000) == 0:
                    save_scalars(self.writer, "train", scalars, step)
                extra = "".join(
                    f", {tag} = {scalars[key]:.3f}"
                    for tag, key in (("seg", "label_loss"), ("lrsc", "lrsc_loss"))
                    if key in scalars
                )
                dt = time.time() - t0
                record["step_s"].append(dt)
                print(
                    f"Epoch {epoch}/{cfg.optim.epochs}, Iter {it}/{len(self.train_loader)}, "
                    f"loss = {scalars['loss']:.3f}, disp = {scalars['disp_loss']:.3f}"
                    f"{extra}, time = {dt:.3f}"
                )
            record["train_s"] = time.perf_counter() - t_epoch
            if (epoch + 1) % cfg.save_freq == 0:
                ckpt.save_checkpoint(cfg.logdir, self.state, epoch)
                barrier()
            self.state.epoch = epoch + 1
            if self.eval_loader is not None:
                t_eval = time.perf_counter()
                record["eval"] = self.evaluate(epoch)
                record["eval_s"] = time.perf_counter() - t_eval
            self.history.append(record)
        return self.state

    def evaluate(self, epoch: int = 0, save_dir: Optional[str] = None) -> dict:
        """One pass over the eval list: the mean of each scalar over the
        batches, and PA/MPA/mIoU with per-class CPA/IoU either from one
        confusion matrix over the list or, with ``cfg.eval_seg_per_batch``,
        as NaN-skipping means of per-batch values.  With ``save_dir``, each
        sample's disparity (and, without ground-truth labels, its label map)
        is written there as a PNG (each process writes its shard's).  Under
        data parallelism every process runs it and gets the results (see
        the module docstring)."""
        cfg = self.cfg
        meters = AverageMeterDict()
        seg_meter = SegmentationMeter(cfg.model.num_classes - 1)
        per_batch = cfg.eval_seg_per_batch
        seg_batch_meter = AverageMeterDictPerKey()
        bs = self.eval_loader.batch_size
        loader_it = iter(self.eval_loader)
        last_raw = None
        for it in range(self._n_eval_steps()):
            raw = next(loader_it, None)
            if raw is None:  # this process's shard ran out: an alignment-only step
                template = last_raw if last_raw is not None else self._template_batch()
                batch, real = _pad_eval_batch(template, bs, cfg.model.maxdisp,
                                              cfg.loss.ignore_index, invalidate_all=True)
            else:
                last_raw = raw
                batch, real = _pad_eval_batch(raw, bs, cfg.model.maxdisp, cfg.loss.ignore_index)
            scalars = self.eval_step(self.state, _device_batch(batch, _EVAL_KEYS, self.device,
                                                               self.mesh))
            cm = scalars.pop("confusion", None)
            disp_est = scalars.pop("disp_est", None)
            label_est = scalars.pop("label_est", None)
            if disp_est is not None:
                disp_est = disp_est.cpu().numpy()
            if save_dir and disp_est is not None:
                # the whole rows, written by the first process of a disp or space group
                whole = [gather_rows(t, self.mesh) for t in (disp_est, label_est)
                         if t is not None]
                if real and self.mesh.disp_index == 0 and self.mesh.space_index == 0:
                    self._save_outputs(save_dir, batch, whole[0][:real],
                                       None if label_est is None else
                                       whole[1].cpu().numpy()[:real])
            if cm is not None:
                # one process of each disp group counts its rows (every
                # process of a space group its own)
                cm = cm.cpu().numpy() * (self.mesh.disp_index == 0)
                if per_batch:
                    (cm,) = all_reduce_sum_tree((cm,))
                    seg_batch_meter.update(_seg_scalars(cm, cfg.model.num_classes - 1))
                else:
                    seg_meter.add_confusion(cm)
            if self.writer and it % cfg.summary_freq == 0 and disp_est is not None:
                self._log_images(epoch, slab_rows(batch, self.mesh), disp_est)
            meters.update(_scalar_floats(scalars) if scalars else {})
        if not per_batch:
            (seg_meter.cm,) = all_reduce_sum_tree((seg_meter.cm,))
        results = meters.mean()
        if per_batch:
            results.update(seg_batch_meter.mean())
        elif seg_meter.cm.sum() > 0:
            results.update(
                PA=seg_meter.pixel_accuracy(),
                MPA=seg_meter.mean_pixel_accuracy(),
                mIoU=seg_meter.mean_iou(),
            )
            per_key = AverageMeterDictPerKey()
            cpa, iou = seg_meter.class_pixel_accuracy(), seg_meter.iou()
            per_key.update({
                **{f"CPA{i}": float(cpa[i]) for i in range(len(cpa))},
                **{f"IoU{i}": float(iou[i]) for i in range(len(iou))},
            })
            results.update(per_key.mean())
        if self.writer:
            save_scalars(self.writer, "fulltest", results, epoch)
        print("avg_test_scalars", results)
        return results

    def _n_eval_steps(self) -> int:
        """The eval steps every process runs: those of the longest shard,
        shard 0 (the loader deals the list round-robin, ``idx[data_index::data]``)."""
        longest = -(-len(self.eval_loader.dataset) // self.mesh.data)
        return -(-longest // self.eval_loader.batch_size)

    def _template_batch(self) -> dict:
        """A one-sample batch for the alignment-only steps of a process whose
        eval shard is empty (its contents are marked invalid before use)."""
        ds = self.eval_loader.dataset
        return collate([ds.get(0, np.random.default_rng(0)) if hasattr(ds, "get") else ds[0]])

    def _log_images(self, epoch: int, batch: dict, disp_est: np.ndarray):
        """TensorBoard image panel: input, estimated and ground-truth
        disparity, KITTI error map."""
        from semstereo_tpu_torch.utils import disp_error_image, save_images

        images = {"imgL": batch["left"][..., 0], "disp_est": disp_est}
        if "disparity" in batch:
            images["disp_gt"] = batch["disparity"]
            images["errormap"] = np.transpose(
                disp_error_image(disp_est, batch["disparity"]), (0, 3, 1, 2))[:, 0]
        save_images(self.writer, "test", images, epoch)

    def _save_outputs(self, save_dir, batch, disp_est, label_est=None):
        """Submission-style dump: one 256 x uint16 disparity PNG (the KITTI
        encoding) per input, named by the sample's ``left_filename`` (else
        its index in the eval list, ``i + N * k`` for the k-th row of shard
        i of N), plus a uint8 label PNG when the labels were
        estimated.  The maps are written at the network's input size, not
        cropped by ``top_pad``/``right_pad``, as the JAX package writes
        them."""
        from PIL import Image

        os.makedirs(save_dir, exist_ok=True)
        names = batch.get("left_filename")
        for i in range(disp_est.shape[0]):
            if names is not None:
                stem = os.path.splitext(os.path.basename(names[i]))[0]
            else:
                stem = f"{self.mesh.data_index + self.mesh.data * self._dump_index:06d}"
                self._dump_index += 1
            d = np.clip(disp_est[i] * 256.0, 0, 65535).astype(np.uint16)
            Image.fromarray(d).save(os.path.join(save_dir, f"{stem}_disp.png"))
            if label_est is not None:
                Image.fromarray(label_est[i].astype(np.uint8)).save(
                    os.path.join(save_dir, f"{stem}_label.png"))
