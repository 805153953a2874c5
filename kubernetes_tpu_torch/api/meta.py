"""Generic object metadata access (ref: pkg/api/meta/ Accessor).

Port of ``kubernetes_tpu/api/meta.py``'s ``accessor``: what the reflector
reads to resume a watch. The RESTMapper is not ported.
"""

from __future__ import annotations

from typing import Any

__all__ = ["accessor"]


class _Accessor:
    """Uniform access to metadata on any API object (ref: meta.Accessor)."""

    def resource_version(self, obj: Any) -> str:
        m = getattr(obj, "metadata", None)
        return getattr(m, "resource_version", "") or ""


accessor = _Accessor()
