"""Each per-layer reader on a small canned trace, through the summary the
harness makes of it."""

import math

import pytest

from stereobench import run
from stereobench.tracing import busy_intervals, open_ranges, summarize


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def canned_trace():
    """A 1000 us window on host thread 1: a module range holding a conv3d
    call (two kernels, launched at 110 and 130) and a gwc call (one kernel,
    launched at 300); a backward conv3d call on thread 2 (one kernel); and
    one kernel launched outside the benchmark's ranges.  Device time: 100
    + 50 + 20 + 200 + 30 us, with an overlap of 10 us."""
    ev = [
        _ev("user_annotation", "sb:window", 0, 1000),
        _ev("user_annotation", "sb:module:hourglass", 100, 300),
        _ev("user_annotation", "sb:conv3d#0", 105, 50),
        _ev("user_annotation", "sb:gwc#1", 290, 20),
        _ev("user_annotation", "sb:phase:step", 0, 990),
        _ev("user_annotation", "sb:conv3d#2", 600, 50, tid=2),
    ]
    launches = [(1, 110, 1), (2, 130, 1), (3, 300, 1), (4, 610, 2), (5, 700, 1)]
    for corr, ts, tid in launches:
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", ts, 5, tid=tid, correlation=corr))
    kernels = [(1, "k1_conv", 200, 100), (2, "k1_conv", 290, 50), (3, "k2_gwc", 400, 20),
               (4, "dw_conv", 620, 200), (5, "elementwise", 900, 30)]
    for corr, name, ts, dur in kernels:
        ev.append(_ev("kernel", name, ts, dur, tid=7, correlation=corr))
    return ev


BOUNDS = {"sb:conv3d#0": ("conv3d", 60e-6), "sb:gwc#1": ("gwc", 5e-6),
          "sb:conv3d#2": ("conv3d", 90e-6)}


def test_summary_of_the_canned_trace():
    s = summarize(canned_trace(), BOUNDS, pairs=2)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(390e-6)  # 100 + 50 - 10 + 20 + 200 + 30
    assert s["kernels"] == 5 and s["attributed_ops"] == 5 and s["unmatched_ops"] == 0
    assert s["layers"]["conv3d"] == {"bound_s": pytest.approx(150e-6),
                                     "kernel_s": pytest.approx(350e-6), "calls": 2}
    assert s["layers"]["gwc"]["kernel_s"] == pytest.approx(20e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["dw_conv"] == pytest.approx(200e-6) and ops["k1_conv"] == pytest.approx(150e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # before k1 at 200: launched in conv3d; before the gwc kernel at 400:
    # gwc; before dw at 620: conv3d (thread 2); before 900: the step phase;
    # 930 .. 1000 after the last operation
    assert gaps["conv3d"] == pytest.approx((200 + 200) * 1e-6)
    assert gaps["gwc"] == pytest.approx(60e-6)
    assert gaps["phase:step"] == pytest.approx(80e-6)
    assert gaps["after the last device operation"] == pytest.approx(70e-6)


def test_busy_intervals_and_open_ranges():
    assert busy_intervals([(5, 7), (0, 2), (1, 3)]) == [[0, 3], [5, 7]]
    rs = [(0, 10, "a"), (2, 4, "b"), (6, 8, "c")]
    assert [[r[2] for r in o] for o in open_ranges(rs, [3, 5, 7, 11])] == [
        ["b", "a"], ["a"], ["c", "a"], []]


def _summary(mode):
    s = summarize(canned_trace(), BOUNDS, pairs=2)
    s.update(mode=mode, rate_pairs_per_s=10.0, model_flop_per_pair=2e12, peak_flops=989e12)
    return s


EXPECTED = {
    "idle_pct": 100 * (1 - 0.39), "launches_per_pair": 2.5,
    "mfu_pct": 100 * 2e13 / 989e12,
    "conv3d_roofline_pct": 100 * 150 / 350, "gwc_roofline_pct": 100 * 5 / 20,
}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(mode, metric):
    name = f"{metric}.{mode}" if "roofline" in metric else f"{mode}_{metric}"
    read = run.reader(name)
    assert read(_summary(mode)) == pytest.approx(EXPECTED[metric])
    other = "train" if mode == "eval" else "eval"
    assert read(_summary(other)) is None  # a reader finds nothing in the other mode's cells


@pytest.mark.parametrize("name", ["conv3d_roofline_pct.eval", "gwc_roofline_pct.train",
                                  "eval_mfu_pct"])
def test_reader_returns_nothing_without_its_layer(name):
    s = _summary(name.split(".")[-1] if "." in name else "eval")
    s["layers"] = {}
    s["model_flop_per_pair"] = None
    assert run.reader(name)(s) is None
    assert not math.isnan(run.reader("eval_idle_pct")(_summary("eval")))
