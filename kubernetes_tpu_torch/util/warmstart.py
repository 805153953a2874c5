"""Warm start: the mesh dispatch calibration across restarts.

Port of the calibration half of ``kubernetes_tpu/util/warmstart.py``. The
solver daemon's mesh executor (solver/mesh_exec.py) times the sharded and
the single-device layouts once per wave shape and keeps the winner in a
JSON store here, so a restarted daemon skips that probe. The reference's
other halves, JAX's persistent compilation cache and the wave router's
calibrations, have no counterpart in the port: the CUDA kernel is built
once into ``ops/_build/`` (keyed by a hash of its sources) and the router
is left out (ROADMAP, "Left out on purpose").

Environment knobs:

- ``KTPU_WARM_START=off``  disable (no calibration is read or written);
- ``KTPU_CACHE_DIR=DIR``   override the location (default:
  ``<repo>/.ktpu_cache``, which is gitignored).
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["cache_dir", "enabled", "mesh_cal_path"]


def enabled() -> bool:
    return os.environ.get("KTPU_WARM_START", "auto").strip().lower() \
        not in ("off", "0", "false")


def cache_dir() -> str:
    override = os.environ.get("KTPU_CACHE_DIR", "").strip()
    if override:
        return override
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, ".ktpu_cache")


def mesh_cal_path(base: Optional[str] = None) -> str:
    """Mesh-dispatch calibration store (solver/mesh_exec.MeshExecutor):
    sharded-vs-single-device timings keyed by (device type, device count,
    pods_axis, plane shape), so a restarted daemon skips the one-time
    crossover probe."""
    return os.path.join(base or cache_dir(), "mesh_cal.json")
