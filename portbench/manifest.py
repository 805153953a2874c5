"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), the traffic's generator
(``generators/<generator>.py``) and each metric's reader
(``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["Cell", "HERE", "ROOT", "cell", "load", "metrics_for", "module"]


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict


def load() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, overrides: dict = None) -> Cell:
    """Cell ``name`` with its configuration and traffic; ``overrides``
    ({"config": {...}, "traffic": {...}}) changes sizes, for tests on the
    CPU only."""
    manifest = load()
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in manifest["configs"] if c["name"] == w["config"]][0]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    overrides = overrides or {}
    return Cell(name, int(w["chips"]),
                {**config, **overrides.get("config", {})},
                {**traffic, **overrides.get("traffic", {})})


def metrics_for(name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer metrics."""
    entries = load()["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under the benchmark, loaded by its path (a name
    may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
