"""Build and load the port's CUDA sources.

Each ``ops/csrc/<name>.cu`` compiles with plain ``nvcc`` into a shared
library with a C interface, loaded through ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries go to ``ops/_build/`` keyed by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one loads at once. Nothing builds at import: the first call that needs a
kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["NVCC_FLAGS", "build", "load", "nvcc_path"]

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# -Xptxas -v only reports registers, shared memory and spills; no
# --use_fast_math: the spread score relies on exact integer arithmetic
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# the compiler's report of the last build of each source (empty when the
# library was already built)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "CUDA kernels build only where the CUDA toolkit is installed")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this exact source
    and flags exists; return the library's path."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        build_logs[name] = ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    build_logs[name] = proc.stderr
    return out


def load(name: str, signatures: Dict[str, Tuple[object, list]]
         ) -> ctypes.CDLL:
    """Build (if needed) and load ``name``, declaring each C function's
    (restype, argtypes). Pointers and the stream must be c_void_p, or
    ctypes passes them as 32-bit ints."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _loaded[name] = lib
    return lib
