"""Train and eval steps: loss assembly per recipe, the gradient update and
the metrics (counterpart of ``semstereo_tpu/train/steps.py``).

Mixed precision as the JAX package has it: the master parameters stay
fp32 and are cast to the compute dtype differentiably for the forward
(``torch.func.functional_call``), so gradients come back in fp32; the BN
running statistics are not cast, so BatchNorm computes and keeps them in
fp32.  The outputs are cast to fp32 before the losses.

Under data parallelism (``parallel.py``) each process runs the step on its
rows of the global batch: its losses and metrics are its shares of the
global-batch values, the gradients are summed over the processes in one
all-reduce before the clip and the update, and the scalars the steps
return are the global values.  Under disparity parallelism the processes
of a disp group hold the same rows, so the world-summed denominators count
those rows ``disp`` times: each process's loss is 1/disp of its rows'
share, and the same world-wide sums of the gradients and scalars give the
global values (the model's slabs send their parts of the gradient back
through the gathers' adjoints).  Under spatial parallelism the processes
of a space group hold distinct rows of the same images, so the masked
means' world-summed denominators count each pixel once and the sums give
the global values as under data parallelism; the dice loss and the
per-image metrics sum their spatial sums over the space group first
(``losses.dice_loss``, ``metrics.py``), on the model's row mesh
(``layers.rows_of``).  Under both, a process holds distinct rows within
its space group and the same rows as the rest of its disp group: the
world-summed denominators count each pixel ``disp`` times, so each
process's loss is 1/disp of its rows' share, the dice loss's world count
of (image, class) pairs counts each pair disp x space times, and the
world-wide sums of the gradients and scalars give the global values.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from semstereo_tpu_torch import losses, metrics
from semstereo_tpu_torch.config import TrainConfig
from semstereo_tpu_torch.nn.layers import rows_of
from semstereo_tpu_torch.parallel import all_reduce_grads, all_reduce_scalars
from semstereo_tpu_torch.train.state import TrainState


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def valid_mask(gt, maxdisp: int, symmetric):
    """Valid pixels: -maxdisp <= d < maxdisp for 'symmetric' (or True),
    0 < d < maxdisp for 'positive' (or False)."""
    if symmetric in (True, "symmetric"):
        return (gt < maxdisp) & (gt >= -maxdisp)
    return (gt < maxdisp) & (gt > 0)


def _display_gt(gt):
    """The large-negative invalid sentinel set to 0 for the metrics."""
    return torch.where(gt < -871.0, 0.0, gt)


def assemble_train_loss(cfg: TrainConfig, out, batch, rows=None):
    """(total loss, dict of its terms, valid mask of the full-res gt); on
    row slabs with ``rows``."""
    model_cfg, loss_cfg = cfg.model, cfg.loss
    gt, gt4 = batch["disparity"], batch["disparity_4"]
    policy = cfg.data.resolved_mask_policy(model_cfg.symmetric)
    mask = valid_mask(gt, model_cfg.maxdisp, policy)
    mask4 = valid_mask(gt4, model_cfg.maxdisp, policy)

    disp_ests = out["disp"]
    n = len(disp_ests)
    gts = [gt, gt4, gt, gt4][:n]
    masks = [m.float() for m in [mask, mask4, mask, mask4][:n]]
    disp_loss = losses.disp_loss_train(disp_ests, gts, masks, losses.DISP_WEIGHTS_FULL[:n])

    total = disp_loss
    aux = {"disp_loss": disp_loss}
    if loss_cfg.use_seg:
        seg = losses.label_loss(out["label_l"], batch["label"], model_cfg.num_classes,
                                model_cfg.att_weights_only, loss_cfg.ignore_index, rows)
        total = total + seg
        aux["label_loss"] = seg
    if loss_cfg.use_lrsc:
        lr_loss = losses.lrsc_loss(out["label_r"], disp_ests[0], batch["label"])
        total = total + lr_loss
        aux["lrsc_loss"] = lr_loss
    elif loss_cfg.use_lrsc_self:
        pseudo = torch.argmax(out["label_l"].detach(), dim=-1).float()
        lr_loss = losses.lrsc_loss(out["label_r"], disp_ests[0], pseudo)
        total = total + lr_loss
        aux["lrsc_loss"] = lr_loss
    aux["loss"] = total
    return total, aux, mask


def _apply(model, cfg: TrainConfig, left, right):
    """The model's forward in the compute dtype on fp32 master parameters;
    outputs in fp32."""
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        out = model(left.float(), right.float())
    else:
        params = {n: p.to(dtype) for n, p in model.named_parameters()}
        out = functional_call(model, params, (left.to(dtype), right.to(dtype)))
    return {k: tuple(t.float() for t in v) if isinstance(v, tuple) else v.float()
            for k, v in out.items()}


def _disp_metrics(est, gt, mask, rows=None):
    est = est.detach()
    return dict(EPE=metrics.epe_metric(est, gt, mask, rows),
                D1=metrics.d1_metric(est, gt, mask, rows),
                Thres1=metrics.thres_metric(est, gt, mask, 1.0, rows),
                Thres2=metrics.thres_metric(est, gt, mask, 2.0, rows),
                Thres3=metrics.thres_metric(est, gt, mask, 3.0, rows))


def make_grads_fn(cfg: TrainConfig):
    """Returns grads(model, batch) -> (aux, out, mask): accumulates into
    each parameter's ``.grad`` the mean gradient over ``cfg.optim.grad_accum``
    microbatches (the leading axis split in turn; each one moves the BN
    running statistics, as the JAX package's microbatch scan threads them).
    ``aux`` holds the loss terms averaged over the microbatches, ``out``
    and ``mask`` the microbatches' outputs and masks concatenated."""
    accum = max(int(cfg.optim.grad_accum), 1)

    def grads(model, batch):
        n = batch["left"].shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        auxs, outs, masks = [], [], []
        for i in range(accum):
            mb = {k: v[i * n // accum:(i + 1) * n // accum] for k, v in batch.items()}
            out = _apply(model, cfg, mb["left"], mb["right"])
            total, aux, mask = assemble_train_loss(cfg, out, mb, rows_of(model))
            (total / accum).backward()
            auxs.append({k: v.detach() for k, v in aux.items()})
            outs.append({k: tuple(t.detach() for t in v) if isinstance(v, tuple) else v.detach()
                         for k, v in out.items()})
            masks.append(mask)
        aux = {k: torch.mean(torch.stack([a[k] for a in auxs])) for k in auxs[0]}
        out = {k: tuple(torch.cat(ts) for ts in zip(*(o[k] for o in outs)))
               if isinstance(outs[0][k], tuple) else torch.cat([o[k] for o in outs])
               for k in outs[0]}
        return aux, out, torch.cat(masks)

    return grads


def _clip_by_global_norm(params, max_norm: float):
    """Scale the gradients by min(1, max_norm / their global norm), as
    optax's ``clip_by_global_norm``."""
    gs = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in gs]))
    torch._foreach_mul_(gs, torch.clamp(max_norm / norm, max=1.0))


def make_train_step(cfg: TrainConfig):
    """Returns train_step(state, batch) -> dict of scalar tensors (the loss
    terms, EPE, D1, Thres1-3): one forward and backward per microbatch,
    the gradients summed over the data-parallel processes, then one Adam
    update of the fp32 master parameters."""
    grads_fn = make_grads_fn(cfg)

    def train_step(state: TrainState, batch):
        model = state.model.train()
        device = next(model.parameters()).device
        batch = {k: v.to(device) for k, v in batch.items()}
        state.optimizer.zero_grad(set_to_none=True)
        aux, out, mask = grads_fn(model, batch)
        all_reduce_grads(model.parameters())
        if cfg.optim.grad_clip > 0:
            _clip_by_global_norm(model.parameters(), cfg.optim.grad_clip)
        state.optimizer.step()
        return all_reduce_scalars(dict(aux, **_disp_metrics(
            out["disp"][0], _display_gt(batch["disparity"]), mask, rows_of(model))))

    return train_step


def make_eval_step(cfg: TrainConfig):
    """Returns eval_step(state, batch) -> dict of scalars (plus the
    confusion matrix under 'confusion' when segmentation is on).  A batch
    without 'disparity' gives the estimates and no metrics."""
    model_cfg = cfg.model
    policy = cfg.data.resolved_mask_policy(model_cfg.symmetric)

    def eval_step(state: TrainState, batch):
        model = state.model.eval()
        rows = rows_of(model)
        device = next(model.parameters()).device
        batch = {k: v.to(device) for k, v in batch.items()}
        out = _apply(model, cfg, batch["left"], batch["right"])
        scalars = {}
        has_gt = "disparity" in batch
        if "disp" in out:
            est = out["disp"][0]
            scalars["disp_est"] = est
            if has_gt:
                gt = batch["disparity"]
                mask = valid_mask(gt, model_cfg.maxdisp, policy)
                scalars["disp_loss"] = losses.disp_loss_eval(est, gt, mask.float())
                scalars.update(_disp_metrics(est, _display_gt(gt), mask, rows))
        if model_cfg.seg_if and "label" in batch:
            scalars["label_loss"] = losses.label_loss(
                out["label_l"], batch["label"], model_cfg.num_classes,
                model_cfg.att_weights_only, cfg.loss.ignore_index, rows)
            scalars["confusion"] = metrics.confusion_matrix(
                out["label_l"], batch["label"], model_cfg.num_classes - 1)
        elif model_cfg.seg_if:
            scalars["label_est"] = torch.argmax(out["label_l"], dim=-1)
        if "disp" in out and has_gt:
            scalars["loss"] = scalars["disp_loss"] + scalars.get("label_loss", 0.0)
        return all_reduce_scalars(scalars)

    return eval_step
