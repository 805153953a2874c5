"""Run a reference test module against the port.

``port_twin("test_http", exclude)`` executes ``tests/test_http.py`` with
every module name of the JAX package (``kubernetes_tpu.…``, in imports
and in strings such as ``-m kubernetes_tpu.cmd.apiserver``) read as the
port's (``kubernetes_tpu_torch.…``), in a namespace of its own, and
returns its tests, classes and fixtures for a ``tests/test_torch_*.py``
module to adopt with ``globals().update(...)``. The twin's cases keep the
reference's names, so each reference case runs once against each package;
a traceback points at the reference file, whose line numbers the rewrite
keeps. ``exclude`` names each case (``"test_fn"``, ``"TestCls"`` or
``"TestCls::test_m"``) that must not run against the port, with the
reason; a name the module does not define is an error, so an exclusion
cannot outlive its case.

``paths=True`` also reads the package's path prefix ``kubernetes_tpu/``
as ``kubernetes_tpu_torch/`` (the vet's rule scopes and fixture paths),
and ``rename`` maps a reference-only name to the port's own (each pair
is replaced verbatim, and must occur in the file). A case that calls an
entry point without a device asks for the CPU through
``port_on_the_cpu``, called from an autouse fixture of the twin module,
since the port's entry points default to ``cuda``; a twin of a mesh
test also calls ``mesh_on_the_cpu``, which builds meshes of eight CPU
shards.
"""

import os
import re
import sys
import types

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
_REFERENCE_NAME = re.compile(r"\bkubernetes_tpu(?=[. ])")
_REFERENCE_PATH = re.compile(r"\bkubernetes_tpu(?=/)")
_DEVICE_USERS = ("models.batch_solver", "models.explain",
                 "scheduler.tpu_batch", "solver.client", "solver.service")


def port_twin(ref_module: str, exclude=None, *, paths: bool = False,
              rename=None) -> dict:
    path = os.path.join(TESTS, ref_module + ".py")
    with open(path) as fh:
        src = _REFERENCE_NAME.sub("kubernetes_tpu_torch", fh.read())
    if paths:
        src = _REFERENCE_PATH.sub("kubernetes_tpu_torch", src)
    for old, new in (rename or {}).items():
        if old not in src:
            raise KeyError(f"{ref_module} has no {old!r}")
        src = src.replace(old, new)
    name = "torch_twin." + ref_module
    mod = types.ModuleType(name)
    mod.__file__ = path
    sys.modules[name] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    ns = dict(mod.__dict__)
    for case in exclude or {}:
        cls, _, meth = case.partition("::")
        if cls not in ns:
            raise KeyError(f"{ref_module} has no {cls}")
        if meth:
            if meth not in vars(ns[cls]):
                raise KeyError(f"{ref_module} has no {case}")
            delattr(ns[cls], meth)
        else:
            del ns[cls]
    return {k: v for k, v in ns.items() if not k.startswith("__")}


def port_on_the_cpu(monkeypatch):
    """For the rest of a case (``monkeypatch``'s), an entry point called
    without a device runs on the CPU (its wrappers' plain versions)
    instead of raising for want of a card; a device the case names is
    kept. A twin module calls it from an autouse fixture."""
    import importlib

    from kubernetes_tpu_torch.models import batch_solver
    real = batch_solver.resolve_device

    def cpu_default(device=None):
        return real("cpu" if device is None else device)
    # every module imported before any is patched: a module first
    # imported after ``batch_solver`` was patched would bind the CPU
    # default as its own, and keep it past the case's undo
    mods = [importlib.import_module("kubernetes_tpu_torch." + name)
            for name in _DEVICE_USERS]
    for mod in mods:
        monkeypatch.setattr(mod, "resolve_device", cpu_default)


def mesh_on_the_cpu(monkeypatch, shards: int = 8):
    """For the rest of a case, a mesh built without named devices (and
    ``maybe_mesh``'s device count) is ``shards`` CPU devices instead of
    the host's CUDA devices: the counterpart of the reference suite's
    ``--xla_force_host_platform_device_count=8`` (tests/conftest.py).
    Entry points run on the CPU too (``port_on_the_cpu``)."""
    import torch

    from kubernetes_tpu_torch.parallel import mesh as pm
    port_on_the_cpu(monkeypatch)
    monkeypatch.setattr(pm, "default_devices",
                        lambda: [torch.device("cpu")] * shards)


def test_twin_rewrites_every_reference_name():
    ns = port_twin("test_storage")
    assert ns["MemStore"].__module__ == "kubernetes_tpu_torch.storage.memstore"
    assert ns["scheme"].__class__.__module__ == \
        "kubernetes_tpu_torch.runtime.scheme"
    assert "kubernetes_tpu" not in ns


def test_twin_refuses_an_exclusion_without_its_case():
    import pytest
    with pytest.raises(KeyError):
        port_twin("test_storage", {"test_no_such_case": "-"})


def test_twin_rewrites_paths_and_renames_on_request():
    ns = port_twin("test_vet", paths=True,
                   rename={'"hack/vet.py"': '"kubernetes_tpu_torch/tools/vet.py"'})
    assert ns["run_vet"].__module__ == "kubernetes_tpu_torch.analysis.engine"
    with pytest.raises(KeyError):
        port_twin("test_storage", rename={"no_such_name": "x"})


def test_port_on_the_cpu_keeps_a_named_device(monkeypatch):
    import torch

    from kubernetes_tpu_torch.models import batch_solver
    from kubernetes_tpu_torch.scheduler import tpu_batch
    port_on_the_cpu(monkeypatch)
    assert tpu_batch.resolve_device().type == "cpu"
    assert batch_solver.resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_solver.resolve_device("cuda")


def test_port_on_the_cpu_is_undone_whole(monkeypatch):
    """After the case's undo, no module keeps the CPU default, the
    importers of ``resolve_device`` included."""
    import importlib

    port_on_the_cpu(monkeypatch)
    monkeypatch.undo()
    from kubernetes_tpu_torch.models import batch_solver
    for name in _DEVICE_USERS:
        mod = importlib.import_module("kubernetes_tpu_torch." + name)
        assert mod.resolve_device is batch_solver.resolve_device, name
