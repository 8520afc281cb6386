"""Eval cells: a closed loop of one client, each request a batch of pairs
through ``models.build_model(cfg, device, dtype)`` and ``model(left,
right)`` (``SemStereo.forward`` under ``inference_mode``), ending when the
final disparity and ``label_l`` are on the host, as ``cli.evaluate
--save-dir`` needs them.

After the window, a sample of the finished requests drawn from the seed
is held to the plain reference in fp32 (``judge.py``), once the program
is freed.  The reference follows the program's hard choices of planes
(``choices.py``), which a re-run of the sampled requests after the window
gives; the re-run's outputs are compared with the window's
(``rerun_gap``), and the reference says how far each choice is from its
own.
"""

from __future__ import annotations

import math

import torch

from stereobench import inputs, judge, loop, reference, weights, work
from stereobench.choices import Choices, batch_of
from stereobench.tracing import summarize


def run(cell, seed: int, seconds: float, tracer, t_start: float, device="cuda") -> dict:
    from semstereo_tpu_torch import ops
    from semstereo_tpu_torch.config import ModelConfig
    from semstereo_tpu_torch.models import build_model

    traffic, dtype = cell.traffic, cell.dtype
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.model.items()}
    sd = weights.make_state_dict(cell.model, seed, device)
    model = build_model(ModelConfig(**fields), device=device, dtype=dtype)
    model.load_state_dict(sd)
    pool = inputs.pairs(traffic, cell.model["num_classes"], seed, device, dtype)
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    pin = torch.device(device).type == "cuda"
    disp_h = torch.empty((b, h, w), dtype=dtype, pin_memory=pin)
    label_h = torch.empty((b, h, w, cell.model["num_classes"]), dtype=dtype, pin_memory=pin)
    served = [0]

    def request():
        rows = pool[served[0] % len(pool)]
        with tracer.phase("forward"):
            out = model(rows["left"], rows["right"])
        with tracer.phase("to_host"):
            disp_h.copy_(out["disp"][0], non_blocking=pin)
            label_h.copy_(out["label_l"], non_blocking=pin)
            loop.sync(device)
        served[0] += 1

    for _ in range(traffic["warmup"]):
        request()
    setup_s = loop.now() - t_start

    ops.reset_launch_counts()
    sample = loop.Reservoir(traffic["compared_requests"], seed)
    latencies = []
    t0 = loop.now()
    end = t0 + seconds
    t1 = t0
    while t1 < end:
        slot = served[0] % len(pool)
        request()
        t = loop.now()
        latencies.append(t - t1)
        t1 = t
        sample.offer(lambda: (slot, disp_h.clone(), label_h.clone()))
    window_s = t1 - t0
    requests = len(latencies)
    launches = {k: v / requests for k, v in ops.launch_counts().items()}
    rate = requests * b / window_s
    res = dict(
        setup_s=setup_s, attempted=requests, failed=0, launches_per_request=launches,
        metrics={"eval_pairs_per_s": rate, "eval_ms_p95": 1e3 * loop.p95(latencies)},
    )
    if tracer.enabled:
        tracer.install(model)
        try:
            events = tracer.profile(request, traffic["profiled_requests"])
        finally:
            tracer.uninstall()
        res["summary"] = summarize(events, tracer.bounds, traffic["profiled_requests"] * b)
        res["summary"].update(
            mode="eval", rate_pairs_per_s=rate,
            model_flop_per_pair=work.model_flop_per_pair(cell.model, b, h, w, train=False),
            peak_flops=work.PEAK_FLOPS[dtype])
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda" else 0)
    choices = Choices()
    choices.install()
    rerun_gap = 0.0
    try:
        for slot, disp, label in sample.items:
            served[0] = slot
            request()
            rerun_gap = max(rerun_gap, (disp_h.float() - disp.float()).abs().max().item(),
                            (label_h.float() - label.float()).abs().max().item())
    finally:
        choices.uninstall()
    del model
    loop.free(device)
    res["readings"] = compare(cell, sd, pool, sample.items, choices.taken, device)
    res["readings"]["rerun_gap"] = rerun_gap
    return res


def reference_outputs(cell, sd, pool, slots, device, precision=None, taken=None):
    """The reference's (disparity, label_l, margins, choices) of each pair
    of the pool's batches ``slots``, one pair at a time in fp32 without
    TF32; following the choices ``taken[i]`` of batch ``slots[i]`` when
    given."""
    ref = reference.build(cell.model, precision).to(device).eval()
    ref.load_state_dict(sd)
    restore = judge.fp32_exact()
    outs = []
    try:
        with torch.no_grad():
            for i, slot in enumerate(slots):
                rows = pool[slot]
                for j in range(rows["left"].shape[0]):
                    forced = None if taken is None else batch_of(taken[i], j, device)
                    out = ref(rows["left"][j:j + 1].float(), rows["right"][j:j + 1].float(),
                              forced)
                    outs.append((out["disp"][0][0].cpu(), out["label_l"][0].cpu(),
                                 {k: v.item() for k, v in out["margins"].items()},
                                 {k: v.cpu() for k, v in out["choices"].items()}))
    finally:
        restore()
    return outs


def numbers(got, want) -> dict:
    """The worst pair's readings: got [(disparity, label_l)], want the
    reference's ``reference_outputs``."""
    return judge.worst([dict(judge.pair_numbers(gd, gl, wd, wl), **margins)
                        for (gd, gl), (wd, wl, margins, _) in zip(got, want)])


def compare(cell, sd, pool, sampled, taken, device) -> dict:
    """The sampled requests against the reference that follows their
    choices."""
    rows = [d.shape[0] for _, d, _ in sampled]
    if [t["topk"].shape[0] for t in taken] != rows:
        # the re-run made its choices for other rows than it served
        return {k: math.inf for k in cell.limits["numbers"]}
    want = reference_outputs(cell, sd, pool, [slot for slot, _, _ in sampled], device,
                             taken=taken)
    got = [(d[j], l[j]) for _, d, l in sampled for j in range(d.shape[0])]
    return numbers(got, want)
