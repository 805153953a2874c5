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
"""

import os
import re
import sys
import types

TESTS = os.path.dirname(os.path.abspath(__file__))
_REFERENCE_NAME = re.compile(r"\bkubernetes_tpu(?=[. ])")


def port_twin(ref_module: str, exclude=None) -> dict:
    path = os.path.join(TESTS, ref_module + ".py")
    with open(path) as fh:
        src = _REFERENCE_NAME.sub("kubernetes_tpu_torch", fh.read())
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
