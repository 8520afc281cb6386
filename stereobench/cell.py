"""A cell of ``BENCHMARK.json`` and the files the harness finds by its names:
``configs/<config>.json``, ``traffic/<cell>.json`` and ``limits/<cell>.json``.

``load`` refuses a file that asks for what the drivers and the reference do
not implement, so that a cell never measures other than what its files
say: one closed-loop client; the configuration's tile; the symmetric
disparity range of SemStereo; the two-pass front end; bf16 or fp32 compute
on fp32 masters; Adam with eps 1e-8 (the port's); the disparity pyramid
with the segmentation and LRSC losses."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# what the drivers and the reference implement: key -> the values accepted
IMPLEMENTED = {
    "traffic": {"mode": ("eval", "train"), "loop": ("closed",), "clients": (1,)},
    "config": {"disparity_range": ("symmetric",), "front_end": ("two_pass",),
               "master_dtype": ("float32",), "compute_dtype": tuple(DTYPES)},
    "model": {"name": ("SemStereo",)},
    "optimizer": {"name": ("adam",), "eps": (1e-8,)},
    "losses": {"disparity": ("smooth_l1_pyramid",), "seg": (True,), "lrsc": (True,)},
}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<cell>.json
    limits: dict  # limits/<cell>.json: number -> its limit and the readings it was set from
    per_layer: list  # the BENCHMARK.json per-layer metrics this cell reports

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.config["compute_dtype"]]

    @property
    def model(self) -> dict:
        return self.config["model"]


def load(name: str) -> Cell:
    m = manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = _json(HERE / "configs" / f"{entry['config']}.json")
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    if traffic["config"] != entry["config"]:
        raise SystemExit(f"traffic {entry['traffic']} is for {traffic['config']}, "
                         f"the cell names {entry['config']}")
    check(name, config, traffic)
    limits = _json(HERE / "limits" / f"{name}.json")
    per_layer = [p for p in m["per_layer"] if name in p.get("workloads", [name])]
    return Cell(name, entry["chips"], config, traffic, limits, per_layer)


def check(name: str, config: dict, traffic: dict) -> None:
    """Refuse a configuration or traffic file that asks for what is not
    implemented (``IMPLEMENTED``)."""
    parts = {"traffic": traffic, "config": config, "model": config["model"],
             "optimizer": config["optimizer"], "losses": config["losses"]}
    bad = [f"{part}.{key} = {parts[part].get(key)!r} (implemented: {list(ok)})"
           for part, keys in IMPLEMENTED.items() for key, ok in keys.items()
           if parts[part].get(key) not in ok]
    if [traffic["height"], traffic["width"]] != list(config["tile"]):
        bad.append(f"traffic {traffic['height']}x{traffic['width']} is not the tile {config['tile']}")
    lo, hi = traffic["shift_range"]
    if not -config["model"]["maxdisp"] <= lo < hi <= config["model"]["maxdisp"]:
        bad.append(f"shift_range {traffic['shift_range']} leaves the symmetric range")
    if bad:
        raise SystemExit(f"{name}: not implemented: " + "; ".join(bad))
