"""Run a kernel source of ``csrc/`` on the CPU, to check its indexing where
there is no card and no ``nvcc``.

``build(src, out_dir)`` compiles ``src`` with ``g++`` against the stand-in
headers in ``include/`` and loads it with ``ctypes``; its C entry points
then take CPU pointers.  Two rewrites make the source ordinary C++: each
``extern __shared__ T name[];`` becomes a pointer to the running block's
shared memory, and each ``kernel<<<grid, block, smem, stream>>>(args)``
becomes a call to ``emu::launch``, which runs every block, one after
another, as one thread per CUDA thread.  The stand-ins cover what the
emulated sources use: the qualifiers, ``dim3``, ``threadIdx`` and
``blockIdx``, ``__syncthreads`` (a ``std::barrier``), ``__nv_bfloat16``
(round to nearest even) and ``tc.cuh``'s cp.async helpers (copies land at
the wait that covers them; invalid ones zero-fill).  It says nothing of
speed, of the card's compiler, or of races between threads that a barrier
happens to order here.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

INCLUDE = Path(__file__).resolve().parent / "include"
GXX_FLAGS = ["-std=c++20", "-O1", "-shared", "-fPIC", "-pthread"]

_SHARED = re.compile(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];")
_LAUNCH = re.compile(r"([A-Za-z_][\w:]*(?:<[^<>;]*>)?)\s*<<<([^>]*)>>>\s*\(")


def translate(text: str) -> str:
    """The source with its shared-memory declarations and launches rewritten."""
    text = _SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(::emu::smem_base);", text)
    return _LAUNCH.sub(r"::emu::launch(\1, ::emu::LaunchCfg{\2}, ", text)


def build(src: Path, out_dir: Path) -> ctypes.CDLL:
    """Compile ``src`` for the CPU into ``out_dir`` and load it."""
    src, out_dir = Path(src), Path(out_dir)
    cpp = out_dir / f"{src.stem}.cpp"
    cpp.write_text(f'#line 1 "{src}"\n' + translate(src.read_text()))
    lib = out_dir / f"lib{src.stem}_emu.so"
    cmd = ["g++", *GXX_FLAGS, "-I", str(INCLUDE), "-o", str(lib), str(cpp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name}:\n{res.stderr}")
    return ctypes.CDLL(str(lib))
