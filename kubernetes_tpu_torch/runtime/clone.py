"""Fast isolation copies of API object trees.

Port of ``kubernetes_tpu/runtime/clone.py``. API objects are trees of
dataclasses, dicts, lists, tuples and atomic leaves (no cycles, no
aliasing to preserve), so a copy walks declared dataclass fields and
containers and shares immutable leaves — the port's ``Quantity`` among
them — instead of paying ``copy.deepcopy``'s memo and reduce dispatch on
every leaf. Anything unrecognised falls back to ``copy.deepcopy``.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
from enum import Enum

from kubernetes_tpu_torch.api.quantity import Quantity

__all__ = ["deep_clone"]

_ATOMIC = frozenset({
    str, int, float, bool, bytes, type(None),
    datetime.datetime, datetime.date, datetime.timedelta,
    Quantity,          # value-immutable: no method assigns ``value``
})

# class -> tuple of field names, resolved once per dataclass type
_FIELDS: dict = {}


def _fields_of(cls):
    f = _FIELDS.get(cls)
    if f is None:
        f = tuple(fld.name for fld in dataclasses.fields(cls))
        _FIELDS[cls] = f
    return f


def deep_clone(obj):
    """Value-semantics copy of an API object tree."""
    cls = obj.__class__
    if cls in _ATOMIC:
        return obj
    if cls is dict:
        return {k: deep_clone(v) for k, v in obj.items()}
    if cls is list:
        return [deep_clone(v) for v in obj]
    if cls is tuple:
        return tuple(deep_clone(v) for v in obj)
    if isinstance(obj, Enum):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        new = object.__new__(cls)
        d = obj.__dict__
        nd = new.__dict__
        # declared fields only, never __dict__ wholesale: an undeclared
        # attribute is a derived cache of the original's contents
        for name in _fields_of(cls):
            nd[name] = deep_clone(d[name])
        return new
    return copy.deepcopy(obj)
