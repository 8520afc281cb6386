"""Spans at the port's layer boundaries: host and device time of the
model's front end and volume stages, and of the train step's loss,
backward and optimizer.

    from semstereo_tpu_torch import trace
    trace.enable()
    ...                  # eval requests or train steps
    trace.totals()       # {"front": {"count", "host_s", "self_host_s", "device_s"}, ...}
    trace.counts()       # {"front_replay": n, ...}
    trace.reset()

``span(name)`` and ``count(name)`` are the calls the program makes.  The
record is off by default, and then ``span`` reads two flags (this
module's and the profiler's) and returns one shared null context, and
``count`` reads the same two flags and does nothing.  It is on after
``enable()`` until ``disable()``, and by itself while a ``torch.profiler``
session records.  An open span keeps in memory its name, its host start
and end (``time.perf_counter_ns``), its parent (the span open around it)
and the request it belongs to: a span opened with none open around it is
a root (``forward`` in eval, ``step`` in train) and takes a new request
id, which its children share.  Where CUDA is initialised, the span also
records a timing event on the current stream at entry and at exit (not
while that stream captures a graph); under the profiler it opens
``record_function("semstereo:<name>")``, which puts it on the profiler's
clock beside the kernels it launches.

The spans the program opens (``models/semstereo.py``,
``train/steps.py``): ``forward``, ``front`` (eagerly once per view in two
passes and once when the views are fused; once per forward when the
front end's CUDA graph is captured or replayed), ``stage1``, ``stage2``,
``step``, ``loss``, ``backward`` (every microbatch) and ``optimizer``.
They are opened from the thread that runs the forward and the step;
autograd's threads open none.  The counters (``models/semstereo.py``):
``front_replay``, ``front_capture`` and ``front_eager``, one per
forward, by how its front end ran.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 65536  # spans kept; any beyond are counted by dropped()
PREFIX = "semstereo:"  # of the profiler ranges

_NULL = contextlib.nullcontext()
_enabled = False


class _Record:
    """The spans since the last reset, the stack of open ones and a pool
    of timing events that a reset returns for reuse."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.stack: list[_Span] = []
        self.dropped = 0
        self.requests = 0
        self.events: list = []
        self.events_used = 0
        self.counts: dict[str, int] = {}

    def event(self):
        if self.events_used == len(self.events):
            self.events.append(torch.cuda.Event(enable_timing=True))
        self.events_used += 1
        return self.events[self.events_used - 1]


_record = _Record()


class _Span:
    __slots__ = ("name", "index", "parent", "request", "start_ns", "end_ns", "events", "_range")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = None
        self.events = None
        self._range = None

    def __enter__(self):
        rec = _record
        parent = rec.stack[-1] if rec.stack else None
        self.parent = parent
        if parent is None:
            self.request = rec.requests
            rec.requests += 1
        else:
            self.request = parent.request
        kept = len(rec.spans) < MAX_SPANS
        if kept:
            self.index = len(rec.spans)
            rec.spans.append(self)
        else:
            self.index = None
            rec.dropped += 1
        rec.stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        if (kept and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.events = (rec.event(), rec.event())
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self.end_ns = time.perf_counter_ns()
        _record.stack.pop()
        return False


def span(name: str):
    """A context manager around one layer's work: the shared null context
    while the record is off, else a new span."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def count(name: str) -> None:
    """Adds one to the counter ``name`` while the record is on."""
    if _enabled or _profiler._is_profiler_enabled:
        _record.counts[name] = _record.counts.get(name, 0) + 1


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records (the default)."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear the record (between requests or steps: no span may be open)."""
    if _record.stack:
        raise RuntimeError(f"reset inside the open span {_record.stack[-1].name!r}")
    _record.spans.clear()
    _record.dropped = 0
    _record.requests = 0
    _record.events_used = 0
    _record.counts.clear()


def dropped() -> int:
    """Spans not kept since the last reset, the record being full."""
    return _record.dropped


def counts() -> dict:
    """The counters since the last reset, by name."""
    return dict(_record.counts)


def spans() -> list[dict]:
    """The record, in the order the spans opened: per span its ``name``,
    ``parent`` (the index of its parent in this list, None for a root),
    ``request`` id, ``start_ns`` and ``end_ns`` (host), ``host_s``, and
    ``device_s``: the current stream's time from the entry event to the
    exit event, None without events (on the CPU).  A span still open has
    None for its end and times.  Synchronises the card once when the
    record holds events."""
    recs = list(_record.spans)
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    out = []
    for r in recs:
        done = r.end_ns is not None
        out.append({
            "name": r.name,
            "parent": None if r.parent is None else r.parent.index,
            "request": r.request, "start_ns": r.start_ns, "end_ns": r.end_ns,
            "host_s": (r.end_ns - r.start_ns) / 1e9 if done else None,
            "device_s": (r.events[0].elapsed_time(r.events[1]) / 1e3
                         if done and r.events is not None else None),
        })
    return out


def totals() -> dict:
    """Per span name, over the closed spans of the record: ``count``,
    ``host_s``, ``self_host_s`` (less the host time of its child spans)
    and ``device_s`` (the sum over the spans that recorded events, None
    where none did).  Synchronises the card once."""
    recs = spans()
    children_s = [0.0] * len(recs)
    for r in recs:
        if r["parent"] is not None and r["host_s"] is not None:
            children_s[r["parent"]] += r["host_s"]
    out: dict[str, dict] = {}
    for r, child_s in zip(recs, children_s):
        if r["host_s"] is None:
            continue
        t = out.setdefault(r["name"], {"count": 0, "host_s": 0.0, "self_host_s": 0.0,
                                       "device_s": None})
        t["count"] += 1
        t["host_s"] += r["host_s"]
        t["self_host_s"] += r["host_s"] - child_s
        if r["device_s"] is not None:
            t["device_s"] = (t["device_s"] or 0.0) + r["device_s"]
    return out
