"""Build and load the port's CUDA sources.

A library ``<name>`` is every ``ops/csrc/<name>*.cu``: each source
compiles with plain ``nvcc`` into an object, all of them at once in
parallel processes, and the objects link into one shared library with a C
interface, loaded through ``ctypes`` (no PyTorch headers, so a build takes
seconds to a minute). Libraries go to ``ops/_build/`` keyed by a hash of
the sources, the headers (``csrc/*.cuh``) and the flags, so an edited
source rebuilds and an unchanged one loads at once. Nothing builds at
import: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["NVCC_FLAGS", "build", "build_seconds", "load", "nvcc_path",
           "sources"]

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# -Xptxas -v only reports registers, shared memory and spills; no
# --use_fast_math: the spread score relies on exact integer arithmetic
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# the compiler's report of the last build of each library (empty when the
# library was already built)
build_logs: Dict[str, str] = {}
# seconds each source of the last build took to compile, and "link"
build_seconds: Dict[str, Dict[str, float]] = {}


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


def sources(name: str) -> List[Path]:
    """The sources of library ``name``: ``csrc/<name>*.cu``, sorted."""
    return sorted(SRC_DIR.glob(f"{name}*.cu"))


def build(name: str) -> Path:
    """Compile and link library ``name`` unless one of these exact sources,
    headers and flags exists; return the library's path."""
    srcs = sources(name)
    if not srcs:
        raise RuntimeError(f"no sources for {name} in {SRC_DIR}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + sorted(SRC_DIR.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        build_logs[name] = ""
        build_seconds[name] = {}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]

    def compile_one(src: Path, obj: Path):
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], capture_output=True, text=True)
        return proc, time.perf_counter() - t0

    # one nvcc process per source, all started together
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        done = list(pool.map(compile_one, srcs, objs))
    logs, seconds, failed = [], {}, []
    for src, (proc, dt) in zip(srcs, done):
        seconds[src.name] = dt
        logs.append(proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{proc.stderr}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_suffix(f".{tag}.tmp")
        t1 = time.perf_counter()
        proc = subprocess.run([nvcc, "-gencode", NVCC_FLAGS[1], "-shared",
                               "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"linking {name} failed:\n{proc.stderr}")
        seconds["link"] = time.perf_counter() - t1
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_logs[name] = "".join(logs)
    build_seconds[name] = seconds
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
