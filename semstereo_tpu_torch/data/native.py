"""ctypes bridge to the native sample prep (``data/csrc/sampleprep.cpp``, a
copy of the JAX package's ``native/sampleprep.cpp``).

Host work, not a device kernel: fused uint8 -> ImageNet-normalized float32
and strided nearest downsampling.  Built with g++ at first use into the
package's git-ignored ``_build/`` directory (named by a hash of the source
and flags, written to a temporary name and moved into place).  Without
``g++``, or with ``SEMSTEREO_NATIVE=0``, every entry point returns None and
the callers take their numpy path; the fallback is reported once, on
stderr.  ``status()`` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "sampleprep.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_status = "not loaded"


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_DIR / f"libsampleprep-{h.hexdigest()[:16]}.so"


def _build_and_load():
    if os.environ.get("SEMSTEREO_NATIVE", "1") == "0":
        raise RuntimeError("disabled by SEMSTEREO_NATIVE=0")
    so = _so_path()
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ exit {res.returncode}: {res.stderr[-500:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    f32p, u8p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    lib.normalize_image_u8.argtypes = [u8p, f32p, i64, i64, f32p, f32p]
    lib.downsample_nearest_f32.argtypes = [f32p, f32p, i64, i64, i64]
    lib.normalize_image_u8.restype = lib.downsample_nearest_f32.restype = None
    return lib, f"native ({so.name})"


def _load():
    global _lib, _status
    with _lock:
        if _status == "not loaded":
            try:
                _lib, _status = _build_and_load()
            except (OSError, RuntimeError) as e:
                _status = f"numpy fallback ({e})"
                print(f"semstereo_tpu_torch.data.native: sample prep falls back to numpy: {e}",
                      file=sys.stderr)
        return _lib


def available() -> bool:
    return _load() is not None


def status() -> str:
    """'native (<library>)' or 'numpy fallback (<reason>)'."""
    _load()
    return _status


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def normalize_image(img: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray | None:
    """uint8 [H,W,3] -> normalized float32, or None without the library."""
    lib = _load()
    if lib is None or img.dtype != np.uint8 or not img.flags.c_contiguous:
        return None
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"normalize_image takes [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    out = np.empty((h, w, 3), np.float32)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    lib.normalize_image_u8(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _f32p(out),
                           h, w, _f32p(m), _f32p(s))
    return out


def downsample_nearest(arr: np.ndarray, factor: int) -> np.ndarray | None:
    """arr[::factor, ::factor] of a float32 [H, W] map (rows and columns cut
    to whole multiples of ``factor``), or None without the library."""
    lib = _load()
    if lib is None or arr.dtype != np.float32 or not arr.flags.c_contiguous:
        return None
    h, w = arr.shape
    out = np.empty((h // factor, w // factor), np.float32)
    lib.downsample_nearest_f32(_f32p(arr), _f32p(out), h, w, factor)
    return out
