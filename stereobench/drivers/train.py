"""Train cells: a closed loop of steps of ``train.make_train_step(cfg)(state,
batch)`` on the state of ``train.init_state(cfg)``, as ``Trainer.fit``
drives them, each step's scalars read to the host.

Set-up loads the benchmark's weights into the fp32 masters and drives the
first three steps through the same call on the pool's first three
batches (rows that all differ), recording each step's loss, the first
step's loss terms, each leaf's
first gradient (from Adam's first moment after one step) and its change
over the three steps (kept on the host), and the hard choices of planes its forwards make
(``choices.py``); the window goes on with the same state.  After the
window the program is freed and the plain reference follows the same
three steps in fp32, taking the program's choices and saying how far each
is from its own (``judge.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from stereobench import inputs, judge, loop, reference, weights, work
from stereobench.choices import Choices, batch_of
from stereobench.tracing import summarize

CHECKED_STEPS = 3
TERMS = ("disp_loss", "label_loss", "lrsc_loss")


def run(cell, seed: int, seconds: float, tracer, t_start: float, device="cuda") -> dict:
    from semstereo_tpu_torch import ops
    from semstereo_tpu_torch.config import TRAIN_PRESETS, ModelConfig
    from semstereo_tpu_torch.train import init_state, make_train_step

    traffic = cell.traffic
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.model.items()}
    preset, opt = TRAIN_PRESETS[cell.config["preset"]], cell.config["optimizer"]
    cfg = preset.replace(
        model=ModelConfig(**fields), compute_dtype=cell.config["compute_dtype"],
        optim=dataclasses.replace(preset.optim, lr=opt["lr"], betas=tuple(opt["betas"])),
        loss=dataclasses.replace(preset.loss, use_seg=cell.config["losses"]["seg"],
                                 use_lrsc=cell.config["losses"]["lrsc"]))
    sd = weights.make_state_dict(cell.model, seed, device)
    state = init_state(cfg, device=device)
    state.model.load_state_dict(sd)
    train_step = make_train_step(cfg)
    pool = inputs.pairs(traffic, cell.model["num_classes"], seed, device)
    b = traffic["batch"]
    steps = [0]
    nonfinite = [0]

    def step():
        batch = pool[steps[0] % len(pool)]
        with tracer.phase("step"):
            scalars = train_step(state, batch)
        with tracer.phase("to_host"):
            keys = [k for k, v in scalars.items() if v.dim() == 0]
            vals = dict(zip(keys, torch.stack([scalars[k].float() for k in keys]).tolist()))
        steps[0] += 1
        if not all(math.isfinite(v) for v in vals.values()):
            nonfinite[0] += 1
        return vals

    params = dict(state.model.named_parameters())
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    record = {"loss": []}
    choices = Choices()
    choices.install()
    try:
        for i in range(CHECKED_STEPS):
            vals = step()
            record["loss"].append(vals["loss"])
            if i == 0:
                record["terms"] = {k: vals[k] for k in TERMS}
                # a parameter the optimizer holds no moment of got nothing
                moments = {n: state.optimizer.state.get(p, {}).get("exp_avg")
                           for n, p in params.items()}
                record["grad"] = {n: 0.0 if m is None else (m / (1 - beta1)).norm().item()
                                  for n, m in moments.items()}
    finally:
        choices.uninstall()
    record["change"] = {n: (p.detach() - sd[n]).float().cpu() for n, p in params.items()}
    setup_s = loop.now() - t_start

    ops.reset_launch_counts()
    t0 = loop.now()
    end = t0 + seconds
    t1 = t0
    while t1 < end:
        step()
        t1 = loop.now()
    window_s = t1 - t0
    done = steps[0] - CHECKED_STEPS
    rate = done * b / window_s
    res = dict(setup_s=setup_s, attempted=done, failed=nonfinite[0],
               launches_per_request={k: v / done for k, v in ops.launch_counts().items()},
               metrics={"train_pairs_per_s": rate})
    if tracer.enabled:
        tracer.install(state.model)
        try:
            events = tracer.profile(step, traffic["profiled_steps"])
        finally:
            tracer.uninstall()
        res["summary"] = summarize(events, tracer.bounds, traffic["profiled_steps"] * b)
        res["summary"].update(
            mode="train", rate_pairs_per_s=rate,
            model_flop_per_pair=work.model_flop_per_pair(
                cell.model, b, traffic["height"], traffic["width"], train=True),
            peak_flops=work.PEAK_FLOPS[cell.dtype])
    if torch.device(device).type == "cuda":
        res["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        res["metrics"]["train_peak_gib"] = res["memory_peak_bytes"] / 2**30
    else:
        res["memory_peak_bytes"] = 0
    del state, train_step, params
    loop.free(device)
    want = reference_steps(cell, sd, pool[:CHECKED_STEPS], device, taken=choices.taken)
    res["readings"] = judge.train_numbers(record, want)
    return res


def reference_steps(cell, sd, batches, device, precision=None, taken=None) -> dict:
    """The reference's record of the same steps from the same weights: each
    step's loss, the first step's loss terms, each leaf's first gradient and its change over the steps,
    the margins of the first step's choices when it follows ``taken[i]``
    at step ``i`` (later steps start from states that Adam's first,
    sign-like update has moved apart by rounding), and each step's choices; in fp32 without TF32,
    each module recomputed in the backward (``lean``)."""
    m = cell.model
    ref = reference.build(m, precision, lean=True).to(device).train()
    ref.load_state_dict(sd)
    params = dict(ref.named_parameters())
    o = cell.config["optimizer"]
    opt = reference.Adam(params.values(), lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"])
    restore = judge.fp32_exact()
    record = {"loss": [], "margins": {}, "choices": [],
              "rank": {n: p.dim() for n, p in params.items()}}
    try:
        for i, batch in enumerate(batches):
            for p in params.values():
                p.grad = None
            forced = None if taken is None else batch_of(taken[i], None, device)
            out = ref(batch["left"].float(), batch["right"].float(), forced)
            terms = reference.losses(out, batch, m["maxdisp"], m["num_classes"],
                                     m["att_weights_only"])
            loss = terms["loss"]
            if i == 0:
                record["margins"] = {k: v.item() for k, v in out["margins"].items()}
            record["choices"].append({k: v.cpu() for k, v in out["choices"].items()})
            del out
            loss.backward()
            record["loss"].append(loss.item())
            if i == 0:
                record["terms"] = {k: terms[k].item() for k in TERMS}
                record["grad"] = {n: p.grad.norm().item() for n, p in params.items()}
                record["kept"] = judge.kept_elements({n: p.grad for n, p in params.items()})
            opt.step()
    finally:
        restore()
    record["change"] = {n: (p.detach() - sd[n]).cpu() for n, p in params.items()}
    return record
