"""What importing the harness adds to ``sys.modules``: neither JAX nor the
JAX package, compared by whole top-level names (the port's name begins
with the JAX package's); and the reference adds nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PROBE = """
import json, sys
before = set(sys.modules)
import importlib
for name in {names!r}:
    importlib.import_module(name)
added = sorted({{m.split(".")[0] for m in set(sys.modules) - before}})
print(json.dumps(added))
"""
HARNESS = ["stereobench.run", "stereobench.drivers.eval", "stereobench.drivers.train",
           "stereobench.reference", "stereobench.control", "stereobench.tracing"]


def _added(names):
    out = subprocess.run([sys.executable, "-c", PROBE.format(names=names)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("names", [HARNESS, HARNESS + ["semstereo_tpu_torch.train",
                                                       "semstereo_tpu_torch.models"]])
def test_harness_and_port_load_no_jax(names):
    added = _added(names)
    assert not added & {"jax", "jaxlib", "flax", "semstereo_tpu"}, added


def test_reference_loads_nothing_of_the_port():
    added = _added(["stereobench.reference", "stereobench.weights", "stereobench.inputs"])
    assert not added & {"jax", "jaxlib", "flax", "semstereo_tpu", "semstereo_tpu_torch"}, added
    assert "torch" in added
