"""Pod config sources + merger (ref: pkg/kubelet/config/).

Three sources in the reference — file (file.go:41), URL (http.go:41), and
apiserver watch (apiserver.go:29) — merged by ``PodConfig``/Mux with
per-source tracking (config.go:53-63). Here: ``FileSource`` (a directory of
JSON manifests, doubling as the URL source's decode path), and
``ApiserverSource`` (list+watch of pods bound to this node). Each source
reports its complete snapshot; the mux merges the per-source snapshots and
emits one SET update (the kubelet is level-triggered, so SET is the only op
it needs; the reference's ADD/UPDATE/REMOVE ops are a delta encoding of the
same stream).

Port of ``kubernetes_tpu/kubelet/config.py``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.latest import scheme as default_scheme
from kubernetes_tpu_torch.client.cache import Reflector, Store
from kubernetes_tpu_torch.controllers.util import run_periodic

__all__ = ["PodUpdate", "PodConfig", "FileSource", "HTTPSource", "ApiserverSource",
           "ConfigSourceAnnotation"]

SET = "SET"
ConfigSourceAnnotation = "kubernetes.io/config.source"


@dataclass
class PodUpdate:
    """ref: config.PodUpdate (pkg/kubelet/types.go)."""

    op: str = SET
    pods: List[api.Pod] = field(default_factory=list)
    source: str = ""


class PodConfig:
    """Merges per-source snapshots into one update channel
    (ref: config.PodConfig + Mux, config.go:53-63)."""

    def __init__(self):
        # bounded + coalescing: every queued PodUpdate is a FULL merged
        # snapshot, so a slow kubelet sync loop drops superseded old
        # entries (latest wins) instead of buffering unbounded history
        self.updates: "queue.Queue[PodUpdate]" = queue.Queue(maxsize=64)
        self._lock = threading.Lock()
        self._per_source: Dict[str, List[api.Pod]] = {}

    def merge(self, source: str, pods: List[api.Pod]) -> None:
        with self._lock:
            stamped = []
            for p in pods:
                p.metadata.annotations.setdefault(ConfigSourceAnnotation, source)
                stamped.append(p)
            self._per_source[source] = stamped
            merged: Dict[str, api.Pod] = {}
            for src in sorted(self._per_source):
                for p in self._per_source[src]:
                    merged[p.metadata.uid or p.metadata.name] = p
            update = PodUpdate(op=SET, pods=list(merged.values()),
                               source=source)
            # never block here: a blocking put while holding _lock would
            # wedge every other source (and seen_sources) behind a
            # stalled consumer, and a source's stop() could not
            # interrupt it. Older snapshots are strictly superseded by
            # this one, so dropping the oldest is lossless.
            while True:
                try:
                    self.updates.put_nowait(update)
                    break
                except queue.Full:
                    try:
                        self.updates.get_nowait()
                    except queue.Empty:
                        pass

    def seen_sources(self) -> List[str]:
        with self._lock:
            return sorted(self._per_source)


def _apply_static_pod_defaults(pod: api.Pod, source: str,
                               hostname: str) -> api.Pod:
    """Static pod normalization shared by the file and URL sources: default
    namespace, ``-<hostname>`` name suffix, deterministic uid, pinned host,
    source annotation (ref: config/file.go + http.go applyDefaults)."""
    if not pod.metadata.namespace:
        pod.metadata.namespace = api.NamespaceDefault
    if not pod.metadata.name.endswith("-" + hostname):
        pod.metadata.name = f"{pod.metadata.name}-{hostname}"
    if not pod.metadata.uid:
        pod.metadata.uid = f"{source}-{pod.metadata.namespace}-{pod.metadata.name}"
    pod.spec.host = hostname
    pod.metadata.annotations[ConfigSourceAnnotation] = source
    return pod


class FileSource:
    """Static pods from a directory of JSON manifests (ref: config/file.go:41).

    Static pod names get a ``-<hostname>`` suffix and a deterministic uid so
    mirror pods are stable across kubelet restarts (ref: file.go applyDefaults).
    """

    def __init__(self, config: PodConfig, path: str, hostname: str,
                 period: float = 5.0, scheme=None):
        self.config = config
        self.path = path
        self.hostname = hostname
        self.period = period
        self.scheme = scheme or default_scheme
        self._stop = threading.Event()

    def read_once(self) -> List[api.Pod]:
        pods = []
        if not os.path.isdir(self.path):
            return pods
        for fname in sorted(os.listdir(self.path)):
            if not fname.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.path, fname)) as f:
                    obj = self.scheme.decode(f.read())
            except Exception:
                continue  # a bad manifest must not poison the others
            if not isinstance(obj, api.Pod):
                continue
            pods.append(_apply_static_pod_defaults(obj, "file", self.hostname))
        return pods

    def sync(self) -> None:
        self.config.merge("file", self.read_once())

    def run(self) -> "FileSource":
        run_periodic(self.sync, self.period, "file-source", self._stop)
        return self

    def stop(self) -> None:
        self._stop.set()


class HTTPSource:
    """Static pods from a manifest URL (ref: config/http.go:41): GET the
    URL each period; the body is one Pod or a PodList manifest."""

    def __init__(self, config: PodConfig, url: str, hostname: str,
                 period: float = 5.0, scheme=None):
        self.config = config
        self.url = url
        self.hostname = hostname
        self.period = period
        self.scheme = scheme or default_scheme
        self._stop = threading.Event()

    def read_once(self) -> Optional[List[api.Pod]]:
        """None on fetch/decode failure (keep last state); [] is a
        legitimately empty manifest (tear static pods down)."""
        import urllib.request
        try:
            with urllib.request.urlopen(self.url, timeout=10) as r:
                obj = self.scheme.decode(r.read())
        except Exception:
            return None
        if isinstance(obj, api.PodList):
            pods = list(obj.items)
        elif isinstance(obj, api.Pod):
            pods = [obj]
        else:
            # decoded but wrong kind (misconfigured URL serving some other
            # object): an error, not an empty manifest — keep last state
            # (ref: config/http.go rejects unknown types)
            return None
        return [_apply_static_pod_defaults(p, "http", self.hostname)
                for p in pods if isinstance(p, api.Pod)]

    def sync(self) -> None:
        pods = self.read_once()
        if pods is not None:
            self.config.merge("http", pods)

    def run(self) -> "HTTPSource":
        run_periodic(self.sync, self.period, "http-source", self._stop)
        return self

    def stop(self) -> None:
        self._stop.set()


class _NotifyStore(Store):
    """A cache.Store that re-merges into the PodConfig on every mutation —
    this is how the apiserver watch becomes a snapshot source."""

    def __init__(self, on_change):
        super().__init__()
        self._on_change = on_change

    def _notify(self):
        self._on_change(self.list())

    def add(self, obj):
        super().add(obj)
        self._notify()

    def update(self, obj):
        super().update(obj)
        self._notify()

    def delete(self, obj):
        super().delete(obj)
        self._notify()

    def replace(self, objs):
        super().replace(objs)
        self._notify()


class ApiserverSource:
    """Pods bound to this node, via list+watch (ref: config/apiserver.go:29 —
    NewSourceApiserver uses a Reflector on field selector spec.host=<node>)."""

    def __init__(self, config: PodConfig, client, hostname: str):
        self.config = config
        self.client = client
        self.hostname = hostname
        store = _NotifyStore(lambda pods: self.config.merge("api", pods))
        self._reflector = Reflector(
            client.pods(api.NamespaceAll).list_watch(
                field_selector=f"spec.host={hostname}"),
            store, name=f"apiserver-source-{hostname}")

    def run(self) -> "ApiserverSource":
        self._reflector.run()
        return self

    def stop(self) -> None:
        self._reflector.stop()
