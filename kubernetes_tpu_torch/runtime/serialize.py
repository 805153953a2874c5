"""Generic dataclass <-> wire-dict serialization.

Port of ``kubernetes_tpu/runtime/serialize.py`` (ref: pkg/conversion/
converter.go, pkg/runtime/scheme.go), the seam the wire codec walks:

- ``to_wire(obj)``   -> JSON-able dict, snake_case fields become camelCase,
  None and empty collections are omitted (like ``omitempty``), Quantity and
  datetimes get canonical string encodings.
- ``from_wire(cls, data)`` -> instance, camelCase mapped back to
  snake_case; a wire field the target type does not declare is ignored,
  as the reference does. The port's types carry every field the
  reference's do for the kinds the scheduler decodes (tests/
  test_torch_codec.py walks both type trees), so nothing the apiserver
  writes is dropped.

Per-field name overrides use dataclass ``metadata={"wire": "name"}``. Both
directions run through per-class compiled plans: the type-hint walk
happens once per class, producing closures that encode/decode each field
without reflection.
"""

from __future__ import annotations

import dataclasses
import datetime
import re
import typing
from typing import (Any, Callable, Dict, Optional, get_args, get_origin,
                    get_type_hints)

from kubernetes_tpu_torch.api.quantity import Quantity

__all__ = ["to_wire", "from_wire", "camel"]

_HINTS_CACHE: Dict[type, Dict[str, Any]] = {}


def camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _wire_name(f: dataclasses.Field) -> str:
    return f.metadata.get("wire", camel(f.name))


def _encode_datetime(obj) -> str:
    if isinstance(obj, str):  # tolerate pre-formatted RFC3339 strings
        return obj
    if obj.tzinfo is not None:
        obj = obj.astimezone(datetime.timezone.utc)
    base = obj.strftime("%Y-%m-%dT%H:%M:%S")
    if obj.microsecond:
        base += f".{obj.microsecond:06d}".rstrip("0")
    return base + "Z"


# -- encode ------------------------------------------------------------------

# per-class encode plan: (attr, wire name, default, keep_empty,
# default-factory-produces-empty, compiled field encoder or None for the
# generic walker). fields()/metadata/camel per encode showed up as ~20% of
# the apiserver's per-request cost at churn rates; hint-compiled field
# encoders remove the per-value isinstance dispatch on top.
_ENCODE_PLAN: Dict[type, list] = {}


def _compile_encoder(hint: Any) -> Optional[Callable[[Any], Any]]:
    """Encoder closure for a type hint, or None meaning "use the generic
    to_wire walker" (Any / unions / unrecognized)."""
    hint = _strip_optional(hint)
    if hint is Quantity:
        return str
    if hint is datetime.datetime:
        return _encode_datetime
    if hint in (str, int, float, bool):
        return None  # JSON-able as-is; generic walker returns it untouched
    origin = get_origin(hint)
    if origin in (list, tuple):
        item_hint = (get_args(hint) or (Any,))[0]
        item = _compile_encoder(item_hint)
        if item is None:
            return lambda v: [to_wire(x) for x in v]
        return lambda v: [None if x is None else item(x) for x in v]
    if origin is dict:
        args = get_args(hint)
        val_hint = args[1] if len(args) == 2 else Any
        val = _compile_encoder(val_hint)
        if val is None:
            return lambda v: {k: to_wire(x) for k, x in v.items()}
        return lambda v: {k: None if x is None else val(x)
                          for k, x in v.items()}
    if dataclasses.is_dataclass(hint) and isinstance(hint, type):
        # dispatch on the runtime class (subclass-safe), plan built lazily
        return _encode_dataclass
    return None


def _encode_plan(cls: type) -> list:
    plan = _ENCODE_PLAN.get(cls)
    if plan is None:
        plan = []
        hints = _hints(cls)
        for f in dataclasses.fields(cls):
            factory_empty = (f.default_factory is dataclasses.MISSING
                             or not f.default_factory())
            plan.append((f.name, _wire_name(f), f.default,
                         bool(f.metadata.get("keep_empty")), factory_empty,
                         _compile_encoder(hints.get(f.name, Any))))
        _ENCODE_PLAN[cls] = plan
    return plan


def _encode_dataclass(obj: Any) -> dict:
    out = {}
    for name, wire, default, keep, factory_empty, enc in \
            _encode_plan(obj.__class__):
        v = getattr(obj, name)
        if v is None:
            continue
        # omitempty: skip fields still at their default value — decoding
        # restores the same default, so round-trips are exact.
        if default is not dataclasses.MISSING and v == default and not keep:
            continue
        if isinstance(v, (list, dict)) and not v and not keep:
            # only omit an empty collection when decoding restores the
            # same empty value — a non-empty default (e.g. NamespaceSpec
            # .finalizers) must be encoded explicitly or a cleared list
            # would resurrect the default on round-trip.
            if factory_empty:
                continue
        out[wire] = to_wire(v) if enc is None else enc(v)
    return out


def to_wire(obj: Any) -> Any:
    """Encode an API object (dataclass tree) into a JSON-able structure."""
    if obj is None:
        return None
    if isinstance(obj, Quantity):
        return str(obj)
    if isinstance(obj, datetime.datetime):
        return _encode_datetime(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _encode_dataclass(obj)
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)):
        return obj
    raise TypeError(f"cannot serialize {type(obj)!r}")


# -- decode ------------------------------------------------------------------

def _hints(cls: type) -> Dict[str, Any]:
    h = _HINTS_CACHE.get(cls)
    if h is None:
        h = get_type_hints(cls)
        _HINTS_CACHE[cls] = h
    return h


def _strip_optional(t: Any) -> Any:
    if get_origin(t) is typing.Union:
        args = [a for a in get_args(t) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return t


def _decode_datetime(data: Any) -> datetime.datetime:
    if isinstance(data, datetime.datetime):
        return data
    # RFC3339 in all common shapes: fractional seconds, 'Z' or numeric offset.
    s = data[:-1] + "+00:00" if data.endswith("Z") else data
    # RFC3339 allows ANY fraction length, and our own encoder right-trims
    # zeros (".3506" for 350600us) — but py3.10 fromisoformat only accepts
    # exactly 3 or 6 digits, so ~11% of emitted timestamps failed to parse
    # (the flaky "Invalid isoformat string" pod-status decode errors). Pad
    # or truncate the fraction to microsecond precision first.
    m = re.match(r"^(.*[Tt ]\d{2}:\d{2}:\d{2})\.(\d+)(.*)$", s)
    if m:
        s = f"{m.group(1)}.{(m.group(2) + '000000')[:6]}{m.group(3)}"
    dt = datetime.datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.astimezone(datetime.timezone.utc)


def _identity(v: Any) -> Any:
    return v


def _compile_decoder(hint: Any) -> Callable[[Any], Any]:
    """Decoder closure for a type hint; callers handle the None case."""
    hint = _strip_optional(hint)
    if hint is Any:
        return _identity
    if hint is Quantity:
        return Quantity
    if hint is datetime.datetime:
        return _decode_datetime
    origin = get_origin(hint)
    if origin in (list, tuple):
        item = _compile_decoder((get_args(hint) or (Any,))[0])
        return lambda v: [None if x is None else item(x) for x in v]
    if origin is dict:
        args = get_args(hint)
        val = _compile_decoder(args[1] if len(args) == 2 else Any)
        return lambda v: {k: None if x is None else val(x)
                          for k, x in v.items()}
    if dataclasses.is_dataclass(hint) and isinstance(hint, type):
        return lambda v: _decode_dataclass(hint, v)
    if hint in (str, int, float, bool):
        return lambda v: hint(v) if not isinstance(v, hint) else v
    # Unparameterized builtin containers or unknown hints: pass through.
    return _identity


# per-class decode plan: wire name -> (attr name, compiled decoder)
_DECODE_PLAN: Dict[type, Dict[str, tuple]] = {}


def _decode_plan(cls: type) -> Dict[str, tuple]:
    plan = _DECODE_PLAN.get(cls)
    if plan is None:
        hints = _hints(cls)
        plan = {}
        for f in dataclasses.fields(cls):
            plan[_wire_name(f)] = (f.name,
                                   _compile_decoder(hints.get(f.name, Any)))
        _DECODE_PLAN[cls] = plan
    return plan


def _decode_dataclass(cls: type, data: Any) -> Any:
    if not isinstance(data, dict):
        raise TypeError(
            f"expected object for {cls.__name__}, got {type(data).__name__}")
    plan = _decode_plan(cls)
    kwargs = {}
    for k, v in data.items():
        slot = plan.get(k)
        if slot is None:
            continue  # unknown field: ignore (forward compatibility)
        name, dec = slot
        kwargs[name] = None if v is None else dec(v)
    return cls(**kwargs)


def from_wire(cls: Any, data: Any) -> Any:
    """Decode a JSON-able structure into ``cls`` (a dataclass or builtin)."""
    if data is None:
        return None
    cls = _strip_optional(cls)
    if dataclasses.is_dataclass(cls) and isinstance(cls, type):
        return _decode_dataclass(cls, data)
    return _compile_decoder(cls)(data)
