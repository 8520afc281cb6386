"""The control of a cell's ``correct``: the plain reference put in the
program's place, computed in the next precision below the configuration's
(fp8, ``reference/precision.py``), held to the fp32 reference by
the cell's own numbers and limits.  It has to come out as not correct.

    python3 stereobench/control.py --workload <cell> --seeds 1,2,3 [--precision fp8_operands]

Eval cells compare as many pairs as a run does (the pool's first
``compared_requests`` batches); train cells the same three steps.  The
fp32 reference follows the control's own choices of planes, as it follows
the program's in a run.  Prints
one JSON line per seed with the readings and the decision.  The benchmark's
own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from stereobench import cell as cells  # noqa: E402
from stereobench import inputs, judge, loop, weights  # noqa: E402
from stereobench.drivers import eval as eval_driver  # noqa: E402
from stereobench.drivers import train as train_driver  # noqa: E402


def readings(cell, seed: int, device="cuda", precision="fp8") -> dict:
    """The control's readings on one seed."""
    sd = weights.make_state_dict(cell.model, seed, device)
    traffic = cell.traffic
    if traffic["mode"] == "eval":
        pool = inputs.pairs(traffic, cell.model["num_classes"], seed, device, cell.dtype)
        slots = list(range(min(traffic["compared_requests"], len(pool))))
        got = eval_driver.reference_outputs(cell, sd, pool, slots, device, precision)
        per_pair, b = [c for _, _, _, c in got], traffic["batch"]
        taken = [{k: torch.cat([c[k] for c in per_pair[i * b:(i + 1) * b]]) for k in per_pair[0]}
                 for i in range(len(slots))]
        want = eval_driver.reference_outputs(cell, sd, pool, slots, device, taken=taken)
        loop.free(device)
        return eval_driver.numbers([(d, l) for d, l, _, _ in got], want)
    pool = inputs.pairs(traffic, cell.model["num_classes"], seed, device)
    pool = pool[:train_driver.CHECKED_STEPS]
    got = train_driver.reference_steps(cell, sd, pool, device, precision)
    loop.free(device)
    want = train_driver.reference_steps(cell, sd, pool, device, taken=got["choices"])
    loop.free(device)
    return judge.train_numbers(got, want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--precision", default="fp8", choices=("fp8", "fp8_operands"),
                   help="every function's output in fp8, or only the products' operands")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, precision=args.precision)
        correct, checks = judge.decide(r, cell.limits)
        print(json.dumps({"workload": cell.name, "seed": seed, "precision": args.precision,
                          "control_correct": correct,
                          "readings": r, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
