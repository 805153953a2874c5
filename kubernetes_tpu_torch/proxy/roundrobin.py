"""Round-robin load balancer with session affinity
(ref: pkg/proxy/roundrobin.go).

``LoadBalancerRR`` keeps, per service, the endpoint list and a rotating
index; ``next_endpoint(service, src_ip)`` returns the next endpoint, or the
affinitized one when the service has ClientIP session affinity and the
client was seen within the TTL (ref: roundrobin.go affinityState /
LoadBalancerRR.NextEndpoint:54-118).

Port of ``kubernetes_tpu/proxy/roundrobin.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import meta_namespace_key_func

__all__ = ["LoadBalancerRR", "ErrMissingServiceEntry", "ErrMissingEndpoints"]


class ErrMissingServiceEntry(Exception):
    pass


class ErrMissingEndpoints(Exception):
    pass


@dataclass
class _AffinityState:
    """ref: roundrobin.go affinityState{clientIP, endpoint, lastUsed}."""

    endpoint: str = ""
    last_used: float = 0.0


@dataclass
class _BalancerState:
    endpoints: List[str] = field(default_factory=list)
    index: int = 0
    affinity_type: str = api.AffinityNone
    ttl_seconds: float = 180 * 60  # ref: proxier.go newServiceInfo default
    affinity_map: Dict[str, _AffinityState] = field(default_factory=dict)


class LoadBalancerRR:
    """ref: roundrobin.go LoadBalancerRR."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._services: Dict[str, _BalancerState] = {}
        self._clock = clock

    def new_service(self, service: str, affinity_type: str = api.AffinityNone,
                    ttl_seconds: float = 0.0) -> None:
        """ref: roundrobin.go NewService."""
        with self._lock:
            state = self._services.setdefault(service, _BalancerState())
            state.affinity_type = affinity_type
            if ttl_seconds > 0:
                state.ttl_seconds = ttl_seconds

    def next_endpoint(self, service: str, src_ip: str = "",
                      reset_affinity: bool = False) -> str:
        """ref: roundrobin.go NextEndpoint:54-118. ``reset_affinity`` drops
        the client's sticky entry first — the dial-retry path uses it so a
        dead affinitized endpoint doesn't pin the client forever
        (ref: proxier.go sessionAffinityReset in TryConnectEndpoints)."""
        with self._lock:
            state = self._services.get(service)
            if state is None:
                raise ErrMissingServiceEntry(service)
            if not state.endpoints:
                raise ErrMissingEndpoints(service)
            use_affinity = (state.affinity_type == api.AffinityClientIP
                            and src_ip)
            if use_affinity and reset_affinity:
                state.affinity_map.pop(src_ip, None)
            if use_affinity and not reset_affinity:
                sess = state.affinity_map.get(src_ip)
                now = self._clock()
                if sess is not None and \
                        now - sess.last_used < state.ttl_seconds and \
                        sess.endpoint in state.endpoints:
                    sess.last_used = now
                    return sess.endpoint
            endpoint = state.endpoints[state.index]
            state.index = (state.index + 1) % len(state.endpoints)
            if use_affinity:
                state.affinity_map[src_ip] = _AffinityState(
                    endpoint=endpoint, last_used=self._clock())
            return endpoint

    def on_update(self, endpoints_list: List[api.Endpoints]) -> None:
        """Full-state endpoints update (ref: roundrobin.go OnUpdate:122-168):
        registered services missing from the update lose their endpoints;
        changed endpoint sets reset the rotation and purge stale affinity."""
        with self._lock:
            seen = set()
            for ep in endpoints_list:
                name = meta_namespace_key_func(ep)
                seen.add(name)
                eps = [f"{e.ip}:{e.port}" for e in ep.endpoints]
                state = self._services.setdefault(name, _BalancerState())
                if sorted(eps) != sorted(state.endpoints):
                    state.endpoints = eps
                    state.index = 0
                    for ip, sess in list(state.affinity_map.items()):
                        if sess.endpoint not in eps:
                            del state.affinity_map[ip]
            for name, state in self._services.items():
                if name not in seen:
                    state.endpoints = []
                    state.index = 0

    def clean_up_stale_sessions(self, service: str) -> None:
        """ref: roundrobin.go removeStaleAffinity."""
        with self._lock:
            state = self._services.get(service)
            if state is None:
                return
            now = self._clock()
            for ip, sess in list(state.affinity_map.items()):
                if now - sess.last_used >= state.ttl_seconds:
                    del state.affinity_map[ip]

    def endpoints_of(self, service: str) -> List[str]:
        with self._lock:
            state = self._services.get(service)
            return list(state.endpoints) if state else []
