"""The readers of the program's spans (``semstereo_tpu_torch.trace``) on a
canned record and summary: ms per pair of their span in their mode, and
None in the other mode, where the span never opened, and for a program
without spans."""

import sys

import pytest

import semstereo_tpu_torch
from semstereo_tpu_torch import trace
from stereobench import run

# a traced window of 2 train steps at batch 4 or of 3 eval requests at batch 1
TOTALS = {
    "forward": {"count": 3, "host_s": 0.150, "self_host_s": 0.020, "device_s": 0.090},
    "front": {"count": 6, "host_s": 0.096, "self_host_s": 0.096, "device_s": 0.030},
    "stage1": {"count": 3, "host_s": 0.012, "self_host_s": 0.012, "device_s": 0.021},
    "stage2": {"count": 3, "host_s": 0.015, "self_host_s": 0.015, "device_s": 0.036},
    "step": {"count": 2, "host_s": 1.6, "self_host_s": 0.1, "device_s": 1.1},
    "loss": {"count": 2, "host_s": 0.004, "self_host_s": 0.004, "device_s": 0.008},
    "backward": {"count": 2, "host_s": 0.4, "self_host_s": 0.4, "device_s": 0.64},
    "optimizer": {"count": 2, "host_s": 0.16, "self_host_s": 0.16, "device_s": 0.056},
}
EVAL = {"front_host_ms.eval": 32.0, "front_device_ms.eval": 10.0,
        "stage1_device_ms.eval": 7.0, "stage2_device_ms.eval": 12.0}
TRAIN = {"front_host_ms.train": 12.0, "loss_device_ms.train": 1.0,
         "backward_host_ms.train": 50.0, "backward_device_ms.train": 80.0,
         "optimizer_host_ms.train": 20.0, "optimizer_device_ms.train": 7.0}
SUMMARY = {"eval": {"mode": "eval", "pairs": 3}, "train": {"mode": "train", "pairs": 8}}


@pytest.fixture
def canned(monkeypatch):
    record = dict(TOTALS)
    monkeypatch.setattr(trace, "totals", lambda: record)
    return record


@pytest.mark.parametrize("name,mode,want", [*((n, "eval", v) for n, v in EVAL.items()),
                                            *((n, "train", v) for n, v in TRAIN.items())])
def test_each_reader_gives_ms_per_pair_of_its_span(canned, name, mode, want):
    read = run.reader(name)
    assert read(SUMMARY[mode]) == pytest.approx(want)
    assert read(SUMMARY["train" if mode == "eval" else "eval"]) is None
    canned.clear()
    assert read(SUMMARY[mode]) is None


def test_no_device_time_reads_none(canned):
    canned["stage2"] = dict(canned["stage2"], device_s=None)
    assert run.reader("stage2_device_ms.eval")(SUMMARY["eval"]) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(semstereo_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "semstereo_tpu_torch.trace", None)
    for name, mode in [*((n, "eval") for n in EVAL), *((n, "train") for n in TRAIN)]:
        assert run.reader(name)(SUMMARY[mode]) is None
