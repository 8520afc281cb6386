"""The reader of the program's front-end counters
(``semstereo_tpu_torch.trace.counts``), ``front_graph_replay_pct.eval``,
on canned counts: the share of eval forwards whose front end was a replay
of its CUDA graph, None in train cells, where nothing was counted, and
for a program without counters or spans."""

import sys

import pytest

import semstereo_tpu_torch
from semstereo_tpu_torch import trace
from stereobench import run

NAME = "front_graph_replay_pct.eval"
SUMMARY = {"eval": {"mode": "eval", "pairs": 3}, "train": {"mode": "train", "pairs": 8}}


@pytest.mark.parametrize("counts,want", [
    ({"front_replay": 3}, 100.0),
    ({"front_replay": 1, "front_capture": 1, "front_eager": 2}, 25.0),
    ({"front_eager": 6}, 0.0),
    ({}, None)])
def test_the_share_of_replayed_front_ends(monkeypatch, counts, want):
    monkeypatch.setattr(trace, "counts", lambda: dict(counts))
    read = run.reader(NAME)
    assert read(SUMMARY["eval"]) == (None if want is None else pytest.approx(want))
    assert read(SUMMARY["train"]) is None


def test_a_program_without_counters_reads_none(monkeypatch):
    read = run.reader(NAME)
    monkeypatch.delattr(trace, "counts")
    assert read(SUMMARY["eval"]) is None
    monkeypatch.delattr(semstereo_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "semstereo_tpu_torch.trace", None)
    assert read(SUMMARY["eval"]) is None
