"""Admission control framework (ref: pkg/admission/).

Port of ``kubernetes_tpu/admission/__init__.py``.

``Attributes`` describes one mutating request; an admission ``Interface``
either admits (possibly mutating the object) or raises a Forbidden
StatusError (ref: pkg/admission/interfaces.go:33-36). Plugins register by
name in a factory map (ref: pkg/admission/plugins.go); a ``Chain`` runs them
in order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from kubernetes_tpu_torch.api import errors

__all__ = ["CREATE", "UPDATE", "DELETE", "Attributes", "Interface", "Chain",
           "register_plugin", "new_from_plugins"]

CREATE = "CREATE"
UPDATE = "UPDATE"
DELETE = "DELETE"


@dataclass
class Attributes:
    operation: str
    resource: str
    namespace: str = ""
    name: str = ""
    obj: Any = None
    user: Any = None
    subresource: str = ""


class Interface:
    def admit(self, attrs: Attributes) -> None:
        """Raise errors.new_forbidden(...) to reject; may mutate attrs.obj."""
        raise NotImplementedError


class Chain(Interface):
    def __init__(self, plugins: List[Interface]):
        self.plugins = plugins

    def admit(self, attrs: Attributes) -> None:
        for p in self.plugins:
            p.admit(attrs)


_FACTORIES: Dict[str, Callable[..., Interface]] = {}


def register_plugin(name: str, factory: Callable[..., Interface]) -> None:
    """ref: admission.RegisterPlugin."""
    _FACTORIES[name] = factory


def new_from_plugins(names: List[str], **kwargs) -> Chain:
    """Instantiate a named plugin chain (ref: admission.NewFromPlugins);
    kwargs (e.g. master registries) are passed to each factory."""
    plugins = []
    for n in names:
        if n not in _FACTORIES:
            raise KeyError(f"unknown admission plugin {n!r}")
        plugins.append(_FACTORIES[n](**kwargs))
    return Chain(plugins)
