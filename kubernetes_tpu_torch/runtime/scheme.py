"""runtime.Scheme — (version, kind) registry + JSON codec.

Port of ``kubernetes_tpu/runtime/scheme.py`` (ref: pkg/runtime/
scheme.go:208-311). The Scheme maps (apiVersion, kind) to the internal
Python type, encodes objects to versioned JSON wire form and decodes wire
form back to internal objects, applying the version's defaulting pass on
decode. Internal types are version-free and "v1" is the identity
encoding (camelCase dataclass form from runtime/serialize.py). The
reference's per-version wire transforms, kind aliases and field-label
conversions exist for its legacy v1beta1/v1beta2 wire, which the port
does not speak (api/latest.py).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional, Tuple, Type

from kubernetes_tpu_torch.runtime.serialize import from_wire, to_wire

__all__ = ["Scheme", "NotRegisteredError"]


class NotRegisteredError(KeyError):
    pass


class Scheme:
    def __init__(self, default_version: str = "v1"):
        self.default_version = default_version
        # version -> kind -> type
        self._types: Dict[str, Dict[str, Type]] = {}
        # (version, kind) -> defaulter(obj), applied on decode
        # (ref: pkg/api/v1beta3/defaults.go addDefaultingFuncs)
        self._defaulters: Dict[Tuple[str, str], Callable[[Any], None]] = {}

    # -- registration -------------------------------------------------------
    def add_known_types(self, version: str, *types_: Type) -> None:
        """ref: scheme.go AddKnownTypes — kind is the type's declared kind."""
        kinds = self._types.setdefault(version, {})
        for t in types_:
            kind = getattr(t, "kind", None)
            if not (isinstance(kind, str) and kind):
                kind = t.__name__
            kinds[kind] = t

    def add_defaulter(self, version: str, kind: str,
                      fn: Callable[[Any], None]) -> None:
        """Defaulting pass applied to objects decoded from this version."""
        self._defaulters[(version, kind)] = fn

    def recognizes(self, version: str, kind: str) -> bool:
        return kind in self._types.get(version, {})

    def type_for(self, version: str, kind: str) -> Type:
        try:
            return self._types[version][kind]
        except KeyError:
            raise NotRegisteredError(
                f"no kind {kind!r} registered for version {version!r}")

    @staticmethod
    def object_kind(obj: Any) -> str:
        return getattr(obj, "kind", "") or type(obj).__name__

    # -- codec --------------------------------------------------------------
    def encode_to_wire(self, obj: Any, version: Optional[str] = None) -> dict:
        version = version or self.default_version
        kind = self.object_kind(obj)
        if not self.recognizes(version, kind):
            raise NotRegisteredError(
                f"kind {kind!r} not registered in version {version!r}")
        wire = to_wire(obj)
        if kind.endswith("List") and "items" not in wire:
            # omitempty drops empty lists, but List kinds always carry
            # items on the wire: clients index .items unconditionally
            wire["items"] = []
        wire["kind"] = kind
        wire["apiVersion"] = version
        return wire

    def encode(self, obj: Any, version: Optional[str] = None) -> str:
        """ref: runtime.Codec.Encode — JSON with kind + apiVersion set."""
        return json.dumps(self.encode_to_wire(obj, version), sort_keys=True)

    def decode_from_wire(self, wire: dict, default_kind: str = "",
                         default_version: str = "") -> Any:
        if not isinstance(wire, dict):
            raise ValueError("expected a JSON object")
        wire = dict(wire)
        kind = wire.pop("kind", "") or default_kind
        version = (wire.pop("apiVersion", "") or default_version
                   or self.default_version)
        if not kind:
            raise ValueError("unable to decode: 'kind' is not set")
        obj = from_wire(self.type_for(version, kind), wire)
        defaulter = self._defaulters.get((version, kind))
        if defaulter is not None:
            defaulter(obj)
        return obj

    def decode(self, data, default_kind: str = "",
               default_version: str = "") -> Any:
        """ref: runtime.Codec.Decode — bytes/str JSON -> internal object."""
        if isinstance(data, (bytes, bytearray)):
            data = data.decode("utf-8")
        return self.decode_from_wire(json.loads(data), default_kind,
                                     default_version)
