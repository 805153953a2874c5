"""runtime.Scheme — (version, kind) registry + codec + conversion seam.

Port of ``kubernetes_tpu/runtime/scheme.py`` (ref: pkg/runtime/
scheme.go:208-311 and pkg/conversion/scheme.go:25-54). The Scheme maps
(apiVersion, kind) to the internal Python type, encodes objects to
versioned JSON wire form and decodes wire form back to internal objects,
applying the version's defaulting pass on decode.

Internal types are version-free; a registered version may own a pair of
wire-dict transforms, kind aliases and field-label conversions. The
default version "v1" is the identity transform (camelCase dataclass
encoding from runtime/serialize.py) and needs none of them; the legacy
"v1beta1" and "v1beta2" (api/v1beta1.py, api/v1beta2.py) register all
three in api/latest.py, as the reference ships v1beta1/v1beta2/v1beta3
side by side.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional, Tuple, Type

from kubernetes_tpu_torch.runtime.serialize import from_wire, to_wire

__all__ = ["Scheme", "NotRegisteredError"]

WireTransform = Callable[[dict], dict]


class NotRegisteredError(KeyError):
    pass


class Scheme:
    def __init__(self, default_version: str = "v1"):
        self.default_version = default_version
        # version -> kind -> type
        self._types: Dict[str, Dict[str, Type]] = {}
        # (version, kind) -> (internal_wire->versioned, versioned->internal_wire)
        self._transforms: Dict[Tuple[str, str], Tuple[WireTransform, WireTransform]] = {}
        # kind -> internal type (shared across versions)
        self._internal: Dict[str, Type] = {}
        # (version, wire kind) -> internal kind and back (e.g. v1beta1
        # "Minion" <-> Node, ref: pkg/api/v1beta1/register.go)
        self._kind_aliases: Dict[Tuple[str, str], str] = {}
        self._kind_alias_out: Dict[Tuple[str, str], str] = {}
        # (version, kind) -> defaulter(obj), applied on decode
        # (ref: pkg/api/v1beta1/defaults.go addDefaultingFuncs)
        self._defaulters: Dict[Tuple[str, str], Callable[[Any], None]] = {}
        # (version, kind) -> fn(label, value) -> (internal label, value)
        # (ref: pkg/api/v1beta1/conversion.go field-label funcs)
        self._field_labels: Dict[Tuple[str, str], Callable] = {}

    # -- registration -------------------------------------------------------
    def add_known_types(self, version: str, *types_: Type) -> None:
        """ref: scheme.go AddKnownTypes — kind is the type's declared kind."""
        kinds = self._types.setdefault(version, {})
        for t in types_:
            kind = getattr(t, "kind", None)
            if not (isinstance(kind, str) and kind):
                kind = t.__name__
            kinds[kind] = t
            self._internal.setdefault(kind, t)

    def add_conversion(self, version: str, kind: str,
                       encode: WireTransform, decode: WireTransform) -> None:
        """Register wire transforms for a (version, kind) pair
        (ref: conversion.Scheme.AddConversionFuncs)."""
        self._transforms[(version, kind)] = (encode, decode)

    def add_kind_alias(self, version: str, wire_kind: str, kind: str) -> None:
        """A version may spell a kind differently on the wire."""
        self._kind_aliases[(version, wire_kind)] = kind
        self._kind_alias_out[(version, kind)] = wire_kind

    def add_defaulter(self, version: str, kind: str,
                      fn: Callable[[Any], None]) -> None:
        """Defaulting pass applied to objects decoded from this version."""
        self._defaulters[(version, kind)] = fn

    def add_field_label_conversion(self, version: str, kind: str,
                                   fn: Callable) -> None:
        """fn(label, value) -> (internal label, value) for field selectors
        expressed in this version's vocabulary."""
        self._field_labels[(version, kind)] = fn

    def convert_field_label(self, version: str, kind: str,
                            label: str, value: str):
        fn = self._field_labels.get((version, kind))
        if fn is None:
            return label, value
        return fn(label, value)

    def is_identity(self, version: str, kind: str) -> bool:
        """Whether ``version`` writes ``kind`` as its plain camelCase
        dataclass encoding: no wire transform and no kind alias."""
        return (version, kind) not in self._transforms \
            and (version, kind) not in self._kind_alias_out

    def versions(self):
        return sorted(self._types)

    def recognizes(self, version: str, kind: str) -> bool:
        return kind in self._types.get(version, {})

    def type_for(self, version: str, kind: str) -> Type:
        try:
            return self._types[version][kind]
        except KeyError:
            raise NotRegisteredError(f"no kind {kind!r} registered for version {version!r}")

    def object_kind(self, obj: Any) -> str:
        kind = getattr(obj, "kind", "") or type(obj).__name__
        return kind

    def new(self, version: str, kind: str) -> Any:
        return self.type_for(version, kind)()

    # -- codec --------------------------------------------------------------
    def encode_to_wire(self, obj: Any, version: Optional[str] = None) -> dict:
        version = version or self.default_version
        kind = self.object_kind(obj)
        if not self.recognizes(version, kind):
            raise NotRegisteredError(f"kind {kind!r} not registered in version {version!r}")
        wire = to_wire(obj)
        if kind.endswith("List") and "items" not in wire:
            # omitempty drops empty lists, but List kinds must always carry
            # items on the wire — clients index .items unconditionally
            wire["items"] = []
        enc, _ = self._transforms.get((version, kind), (None, None))
        if enc is not None:
            wire = enc(wire)
        wire["kind"] = self._kind_alias_out.get((version, kind), kind)
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
        version = wire.pop("apiVersion", "") or default_version or self.default_version
        if not kind:
            raise ValueError("unable to decode: 'kind' is not set")
        kind = self._kind_aliases.get((version, kind), kind)
        t = self.type_for(version, kind)
        _, dec = self._transforms.get((version, kind), (None, None))
        if dec is not None:
            wire = dec(wire)
        obj = from_wire(t, wire)
        defaulter = self._defaulters.get((version, kind))
        if defaulter is not None:
            defaulter(obj)
        return obj

    def decode(self, data, default_kind: str = "", default_version: str = "") -> Any:
        """ref: runtime.Codec.Decode — bytes/str JSON -> internal object."""
        if isinstance(data, (bytes, bytearray)):
            data = data.decode("utf-8")
        return self.decode_from_wire(json.loads(data), default_kind, default_version)

    def deep_copy(self, obj: Any) -> Any:
        """Round-trip copy through the wire form (ref: runtime.Scheme.Copy)."""
        kind = self.object_kind(obj)
        version = self.default_version
        wire = self.encode_to_wire(obj, version)
        return self.decode_from_wire(wire)

    def convert_wire(self, wire: dict, from_version: str, to_version: str) -> dict:
        """Convert a versioned wire dict between versions via the internal form
        (ref: kube-version-change cmd)."""
        obj = self.decode_from_wire(dict(wire), default_version=from_version)
        return self.encode_to_wire(obj, to_version)
