"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, all sources at once (one nvcc process each), into
``semstereo_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
sources and flags so that an edit rebuilds.  ``ptxas -v`` output (registers,
shared memory, spills) is kept beside each library as ``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels build with the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing; returns seconds spent."""
    todo = [(s, _lib_path(s)) for s in sorted(CSRC.glob("*.cu"))]
    todo = [(s, p) for s, p in todo if not p.exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log))
    failed = []
    for proc, tmp, out, log in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{out.name}: nvcc exit {rc}\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(CSRC / f"{name}.cu")))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
