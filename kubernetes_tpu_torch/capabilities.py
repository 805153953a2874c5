"""Process-wide capability switches.

Port of ``kubernetes_tpu/capabilities.py``.

ref: pkg/capabilities/capabilities.go — a once-initialized global that
gates what the system lets pods ask for. v0 has one switch that
matters: AllowPrivileged (the `--allow_privileged` flag on apiserver and
kubelet); validation rejects `privileged: true` containers unless it is
on (validation.go:612-613), and the kubelet refuses to start them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Capabilities:
    allow_privileged: bool = False
    # pod sources allowed to use host networking (reference carries this
    # for static pods; kept for parity of the record type)
    host_network_sources: List[str] = dataclasses.field(default_factory=list)


_lock = threading.Lock()
_capabilities: Optional[Capabilities] = None


def initialize(c: Capabilities) -> None:
    """First call wins; later calls are ignored (capabilities.go Initialize
    — per-binary configuration, not per-request)."""
    global _capabilities
    with _lock:
        if _capabilities is None:
            _capabilities = c


def setup(allow_privileged: bool,
          host_network_sources: Optional[List[str]] = None) -> None:
    """ref: kubelet.go SetupCapabilities — flag-wiring convenience."""
    initialize(Capabilities(allow_privileged=allow_privileged,
                            host_network_sources=host_network_sources or []))


def set_for_tests(c: Optional[Capabilities]) -> None:
    """Tests may re-set freely (capabilities.go SetForTests); None returns
    the process to the never-initialized state."""
    global _capabilities
    with _lock:
        _capabilities = c


def get() -> Capabilities:
    with _lock:
        if _capabilities is None:
            return Capabilities()
        return _capabilities
