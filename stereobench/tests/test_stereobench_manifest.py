"""BENCHMARK.json against the contract's names, units and references, and
the files the harness finds by its names."""

import json
import re

import pytest
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in M[group]:
            yield entry["name"]
    for w in M["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in M["configs"]:
        yield from c["reduced"]


def test_names_and_units():
    names = list(_names())
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = M["end_to_end"] + M["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in M[group]}) == len(M[group])
    for text in [w["why"] for w in M["workloads"]] + [p["layer"] for p in M["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_sources_and_bounds():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1


def _cells_of(metric):
    return set(metric.get("workloads", [w["name"] for w in M["workloads"]]))


def test_per_layer_workloads_report_what_they_move():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for p in M["per_layer"]:
        assert p["moves"] in e2e
        assert set(p["workloads"]) <= _cells_of(e2e[p["moves"]]), p["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in M["workloads"]:
        reported = [m["name"] for m in M["end_to_end"] if w["name"] in _cells_of(m)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in p["workloads"] for p in M["per_layer"])


def test_the_files_each_name_finds():
    here = ROOT / "stereobench"
    for c in M["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    for w in M["workloads"]:
        traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
        assert traffic["config"] == w["config"] and traffic["why"] == w["why"]
        assert traffic["mode"] in ("eval", "train")
        assert (here / "drivers" / f"{traffic['mode']}.py").exists()
        limits = json.loads((here / "limits" / f"{w['name']}.json").read_text())
        assert limits["numbers"]
    for p in M["per_layer"]:
        assert (here / "metrics" / f"{p['name']}.py").exists()
    assert M["paths"] == ["stereobench"] and M["command"][1] == "stereobench/run.py"


@pytest.mark.parametrize("part,key,value", [
    ("traffic", "clients", 4), ("traffic", "loop", "open"), ("traffic", "width", 512),
    ("config", "disparity_range", "positive"), ("config", "front_end", "fused"),
    ("optimizer", "eps", 1e-6), ("losses", "lrsc", False), ("model", "name", "SemStereo_WHU")])
def test_a_setting_the_drivers_do_not_implement_is_refused(part, key, value):
    """A file that asks for what the drivers or the reference do not run is
    refused, not measured as something else."""
    import copy

    from stereobench import cell as cells

    c = cells.load("us3d_s2_eval_b1")
    config, traffic = copy.deepcopy(c.config), dict(c.traffic)
    target = {"traffic": traffic, "config": config, "model": config["model"],
              "optimizer": config["optimizer"], "losses": config["losses"]}[part]
    target[key] = value
    with pytest.raises(SystemExit, match="not implemented"):
        cells.check(c.name, config, traffic)
