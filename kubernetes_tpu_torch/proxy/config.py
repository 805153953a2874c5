"""Watch-driven proxy configuration (ref: pkg/proxy/config/).

``ServiceConfig``/``EndpointsConfig`` watch the API and push full-state
updates into handlers (the Proxier and LoadBalancerRR OnUpdate hooks),
mirroring pkg/proxy/config/config.go's mux→merge→full-state-broadcast
design (handlers always receive the complete object set, never deltas).

Port of ``kubernetes_tpu/proxy/config.py``.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, List

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import Reflector, Store

__all__ = ["ServiceConfig", "EndpointsConfig"]


class _NotifyingStore(Store):
    """Store that flags an event on every mutation, so the broadcast pump
    wakes without polling (stands in for config.go's channel mux)."""

    def __init__(self, notify: threading.Event):
        super().__init__()
        self._notify_event = notify

    def add(self, obj):
        super().add(obj)
        self._notify_event.set()

    def update(self, obj):
        super().update(obj)
        self._notify_event.set()

    def delete(self, obj):
        super().delete(obj)
        self._notify_event.set()

    def replace(self, objs):
        super().replace(objs)
        self._notify_event.set()


class _WatchConfig:
    """List-watch a resource into a Store; on every change, hand the full
    object list to each registered handler."""

    def __init__(self, list_watch, handlers: List[Callable]):
        self._notify = threading.Event()
        self.store = _NotifyingStore(self._notify)
        self.handlers = list(handlers)
        self._lw = list_watch
        self._reflector = None
        self._stop = threading.Event()

    def run(self) -> "_WatchConfig":
        self._reflector = Reflector(self._lw, self.store,
                                    name=f"proxycfg-{type(self).__name__}")
        self._reflector.run()
        t = threading.Thread(target=self._pump, daemon=True,
                             name=f"proxycfg-{type(self).__name__}")
        t.start()
        return self

    def _pump(self) -> None:
        while not self._stop.is_set():
            if not self._notify.wait(timeout=0.5):
                continue
            self._notify.clear()
            objs = self.store.list()
            for h in self.handlers:
                try:
                    h(objs)
                except Exception:
                    # crash-only like the Reflector: a failing handler must
                    # not kill config distribution for every later update
                    traceback.print_exc()

    def stop(self) -> None:
        self._stop.set()
        if self._reflector is not None:
            self._reflector.stop()


class ServiceConfig(_WatchConfig):
    """ref: config.go ServiceConfig — handlers get List[api.Service]."""

    def __init__(self, client, handlers: List[Callable]):
        super().__init__(client.services(api.NamespaceAll).list_watch(),
                         handlers)


class EndpointsConfig(_WatchConfig):
    """ref: config.go EndpointsConfig — handlers get List[api.Endpoints]."""

    def __init__(self, client, handlers: List[Callable]):
        super().__init__(client.endpoints(api.NamespaceAll).list_watch(),
                         handlers)
