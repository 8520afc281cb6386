"""Run one cell of the benchmark on the card and print its result line.

    python3 stereobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s`` from the process's start) builds the
program, makes the weights and the traffic's inputs on the card from the
seed and runs the cell's warm-up; the window then runs for ``--seconds``.
With ``--trace 1`` the profiler follows the window over a few more
requests or steps, and the line holds the cell's per-layer metrics in
place of its end-to-end ones.  A sample of the window's outputs is then
held to the plain reference (``judge.py``); each number compared is
printed beside its limit, last on standard error and last in the line.

The port's nvcc build goes to ``semstereo_tpu_torch/_build/`` inside the
checkout, and Triton's and PyTorch's extension caches to
``stereobench/.cache/``; the trace passes through the temporary
directory.  The run exits with another code than 0, and prints no result,
without enough cards, and if JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "semstereo_tpu")


def environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX pulled in by a
    library that would load it by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def reader(name: str):
    """The per-layer metric reader ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"stereobench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(n: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}


def execute(cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """The cell's run: the driver's result, its metrics for the line and the
    decision on ``correct``."""
    from stereobench import judge
    from stereobench.tracing import Tracer

    driver = importlib.import_module(f"stereobench.drivers.{cell.traffic['mode']}")
    tracer = Tracer(enabled=trace)
    res = driver.run(cell, seed, seconds, tracer, T_START, device=device)
    if trace:
        metrics = {}
        for spec in cell.per_layer:
            value = reader(spec["name"])(res["summary"])
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        metrics = {k: {"value": v, "unit": u} for k, v, u in (
            (k, v, unit_of(k)) for k, v in dict(res["metrics"], setup_s=res["setup_s"]).items())}
    res["line_metrics"] = metrics
    res["correct"], res["checks"] = judge.decide(res["readings"], cell.limits)
    return res


def unit_of(name: str) -> str:
    from stereobench.cell import manifest

    return next(m["unit"] for m in manifest()["end_to_end"] if m["name"] == name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    import torch

    # one host thread: the cells are closed loops of one client, and idle
    # worker threads of the CPU pool compete with the thread that launches
    torch.set_num_threads(1)
    from stereobench import cell as cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"stereobench: {args.workload} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    res = execute(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"stereobench: the run loaded {bad}", file=sys.stderr)
        return 3
    device = device_info(cell.chips)
    device["memory_peak_bytes"] = res["memory_peak_bytes"]
    summary = res.get("summary")
    if summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
    print(f"launches per {'request' if cell.traffic['mode'] == 'eval' else 'step'}: "
          f"{json.dumps(res.get('launches_per_request', {}))}", file=sys.stderr)
    print(f"readings: {json.dumps(res['readings'])}", file=sys.stderr)
    if summary is not None:
        print(f"trace: {json.dumps({k: v for k, v in summary.items() if k != 'breakdown'})}",
              file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["line_metrics"], "device": device}
    if summary is not None:
        line["breakdown"] = summary["breakdown"]
    line["checks"] = res["checks"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
