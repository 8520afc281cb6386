"""Traced runs: ranges around the port's layer calls and top-level modules,
the profiler over the last requests or steps of a run, and the summary of
its trace that the per-layer metric readers take.

In a traced run only, ``Tracer.install`` wraps the public functions of
the two hand-kernel layers where the port's modules call them
(``ops.conv3d``: the eval conv with its folded BatchNorm, the train conv's
forward and backward; ``ops.cost_volume``: the volume's forward and
backward), each call in a ``torch.profiler.record_function`` range named
``sb:<layer>#<n>`` with its least time from ``work.py``; and it opens a
range ``sb:module:<name>`` around each top-level module of the model by
forward hooks.  A device operation belongs to the ranges open on its
launching thread when it was launched (the trace's correlation of each
kernel with its launch), not to a kernel name, so a later change to a
kernel is read on the same work.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from stereobench import work

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cuda_runtime", "cuda_driver")
WINDOW = "sb:window"
NAME_CHARS = 160  # a device operation's name in the breakdown, cut to this length


class Tracer:
    """Ranges of a run traced when ``enabled``; ``active`` while installed."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.bounds: dict[str, tuple[str, float]] = {}  # range name -> (layer, least s)
        self.active = False
        self._undo: list = []
        self._count = 0

    def phase(self, name: str):
        """A range around a step of the driver (``sb:phase:<name>``)."""
        return record_function(f"sb:phase:{name}") if self.active else contextlib.nullcontext()

    def _layer_range(self, layer: str, flops: float, nbytes: float, dtype):
        name = f"sb:{layer}#{self._count}"
        self._count += 1
        self.bounds[name] = (layer, work.bound_s(flops, nbytes, dtype))
        return record_function(name)

    def _patch(self, module, attr: str, make):
        orig = getattr(module, attr)
        setattr(module, attr, make(orig))
        self._undo.append(lambda: setattr(module, attr, orig))

    def install(self, model: torch.nn.Module) -> None:
        import semstereo_tpu_torch.nn.layers as layers
        import semstereo_tpu_torch.ops.conv3d as c3
        import semstereo_tpu_torch.ops.cost_volume as cv

        def conv_eval(orig):
            @functools.wraps(orig)
            def f(x, w, scale, bias, stride=1, relu=False):
                with self._layer_range("conv3d", *work.conv3d_fwd(x.shape, w.shape[4], stride,
                                                                  x.dtype), x.dtype):
                    return orig(x, w, scale, bias, stride, relu)
            return f

        def conv_fwd(orig):
            @functools.wraps(orig)
            def f(x, w, stride, relu=False):
                with self._layer_range("conv3d", *work.conv3d_fwd(x.shape, w.shape[0], stride,
                                                                  x.dtype), x.dtype):
                    return orig(x, w, stride, relu)
            return f

        def conv_bwd(orig):
            @functools.wraps(orig)
            def f(x, w, gy, stride, need_dx=True, need_dw=True):
                fl, nb = work.conv3d_bwd(x.shape, w.shape[0], stride, x.dtype, need_dx, need_dw)
                with self._layer_range("conv3d", fl, nb, x.dtype):
                    return orig(x, w, gy, stride, need_dx, need_dw)
            return f

        def gwc_fwd(orig):
            @functools.wraps(orig)
            def f(left, right, max_shift, num_groups, symmetric=True, plane0=0, planes=None):
                d = planes if planes is not None else (
                    (2 * max_shift if symmetric else max_shift) - plane0)
                with self._layer_range("gwc", *work.gwc_fwd(left.shape, d, left.dtype),
                                       left.dtype):
                    return orig(left, right, max_shift, num_groups, symmetric, plane0, planes)
            return f

        def gwc_bwd(orig):
            @functools.wraps(orig)
            def f(left, right, gbar, *args, **kwargs):
                with self._layer_range("gwc", *work.gwc_bwd(left.shape, gbar.shape[1],
                                                            left.dtype), left.dtype):
                    return orig(left, right, gbar, *args, **kwargs)
            return f

        self._patch(layers, "conv3d_bn_act", conv_eval)
        self._patch(c3, "conv3d_forward", conv_fwd)
        self._patch(c3, "conv3d_backward", conv_bwd)
        self._patch(cv, "gwc_volume_norm_fwd", gwc_fwd)
        self._patch(cv, "gwc_volume_norm_bwd", gwc_bwd)
        for name, child in model.named_children():
            open_ranges = []

            def enter(mod, args, name=name, open_ranges=open_ranges):
                rf = record_function(f"sb:module:{name}")
                rf.__enter__()
                open_ranges.append(rf)

            def leave(mod, args, out, open_ranges=open_ranges):
                open_ranges.pop().__exit__(None, None, None)

            h1 = child.register_forward_pre_hook(enter)
            h2 = child.register_forward_hook(leave)
            self._undo += [h1.remove, h2.remove]
        self.active = True

    def uninstall(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()
        self.active = False

    def profile(self, fn, n: int) -> list:
        """The trace events of ``n`` calls of ``fn`` (each ending with its
        outputs on the host) in a ``sb:window`` range; the trace passes
        through a file under the temporary directory, removed after."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(prefix="stereobench-trace-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def busy_intervals(intervals) -> list:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def open_ranges(ranges, queries) -> list:
    """For each time in ``queries``, the ``ranges`` (start, end, name) open
    at it, innermost (latest started) first; one sweep over both."""
    ranges = sorted(ranges)
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    out = [[] for _ in queries]
    active, j = [], 0
    for i in order:
        t = queries[i]
        while j < len(ranges) and ranges[j][0] <= t:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r[1] >= t]
        out[i] = active[::-1]
    return out


def _short(name: str) -> str:
    return name[3:].split("#")[0]


def summarize(events: list, bounds: dict, pairs: int, top: int = 10) -> dict:
    """The traced window's device busy and wall seconds, device kernels,
    each layer's least and kernel seconds, and the breakdown: the device
    operations that took most time, and the idle gaps summed by the
    innermost range the host was in when it launched the operation that
    ended each gap."""
    window = next(e for e in events if e.get("name") == WINDOW and "dur" in e)
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    ops = [e for e in events if e.get("cat") in DEVICE_OPS and "dur" in e
           and w0 <= float(e["ts"]) <= w1]
    launches = {e["args"]["correlation"]: (e["tid"], float(e["ts"])) for e in events
                if e.get("cat") in LAUNCHES and "correlation" in e.get("args", {})}
    by_tid: dict = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("sb:") and name != WINDOW:
            by_tid.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), name))
    launched = [launches.get(op.get("args", {}).get("correlation"), (None, None)) for op in ops]
    main_tid = window["tid"]
    found = [[] for _ in ops]
    for tid in {t for t, _ in launched if t is not None}:
        idx = [i for i, (t, _) in enumerate(launched) if t == tid]
        own = open_ranges(by_tid.get(tid, []), [launched[i][1] for i in idx])
        main = (open_ranges(by_tid.get(main_tid, []), [launched[i][1] for i in idx])
                if tid != main_tid else [[] for _ in idx])
        for i, a, m in zip(idx, own, main):
            found[i] = a + m

    layer_s: dict[str, float] = {}
    attributed = 0
    by_name: dict[str, float] = {}
    for op, rs in zip(ops, found):
        dur = float(op["dur"]) / 1e6
        name = op["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + dur
        if rs:
            attributed += 1
        layer = next((bounds[r[2]][0] for r in rs if r[2] in bounds), None)
        if layer is not None:
            layer_s[layer] = layer_s.get(layer, 0.0) + dur
    layers = {}
    for name, (layer, least) in bounds.items():
        entry = layers.setdefault(layer, {"bound_s": 0.0, "kernel_s": 0.0, "calls": 0})
        entry["bound_s"] += least
        entry["calls"] += 1
    for layer, entry in layers.items():
        entry["kernel_s"] = layer_s.get(layer, 0.0)

    intervals = busy_intervals((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                               for e in ops)
    busy_us = sum(e - s for s, e in intervals)
    starts = sorted(range(len(ops)), key=lambda i: float(ops[i]["ts"]))
    idle: dict[str, float] = {}
    prev_end = w0
    j = 0
    for s, e in intervals:
        while j < len(starts) and float(ops[starts[j]]["ts"]) < s:
            j += 1
        gap = s - prev_end
        if gap > 0 and j < len(starts):
            rs = found[starts[j]]
            name = _short(rs[0][2]) if rs else "outside the benchmark's ranges"
            idle[name] = idle.get(name, 0.0) + gap / 1e6
        prev_end = e
    if w1 > prev_end:
        idle["after the last device operation"] = (w1 - prev_end) / 1e6
    kernels = sum(1 for e in ops if e.get("cat") == "kernel")
    return {
        "pairs": pairs, "window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
        "kernels": kernels, "device_ops": len(ops), "attributed_ops": attributed,
        "unmatched_ops": sum(1 for t, _ in launched if t is None),
        "layers": layers,
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }
