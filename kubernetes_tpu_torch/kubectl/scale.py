"""Resize (scale) + reapers (stop) + rolling update.

Port of ``kubernetes_tpu/kubectl/scale.py``.

ref: pkg/kubectl/resize.go (ReplicationControllerResizer: precondition
check + retry-on-conflict), pkg/kubectl/stop.go (RCReaper: resize to 0,
wait, delete), pkg/kubectl/rolling_updater.go (RollingUpdater.Update:
scale new RC up one replica at a time while scaling the old one down).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api

__all__ = ["ResizePrecondition", "Resizer", "RCReaper", "RollingUpdater",
           "RetryParams"]


@dataclass
class ResizePrecondition:
    """ref: resize.go ResizePrecondition{Size, ResourceVersion}."""

    size: int = -1                 # -1 = don't check
    resource_version: str = ""     # "" = don't check

    def validate(self, rc: api.ReplicationController) -> None:
        if self.size >= 0 and rc.spec.replicas != self.size:
            raise PreconditionError(
                f"Expected replicas to be {self.size}, was {rc.spec.replicas}")
        if self.resource_version and \
                rc.metadata.resource_version != self.resource_version:
            raise PreconditionError(
                f"Expected resource version {self.resource_version}, "
                f"was {rc.metadata.resource_version}")


class PreconditionError(Exception):
    pass


@dataclass
class RetryParams:
    """ref: resize.go RetryParams{Interval, Timeout}."""

    interval: float = 0.1
    timeout: float = 10.0


class Resizer:
    """ref: resize.go ReplicationControllerResizer."""

    def __init__(self, client):
        self.client = client

    def resize_simple(self, namespace: str, name: str,
                      preconditions: Optional[ResizePrecondition],
                      new_size: int) -> api.ReplicationController:
        rcs = self.client.resource("replicationcontrollers", namespace)
        rc = rcs.get(name)
        if preconditions:
            preconditions.validate(rc)
        rc.spec.replicas = new_size
        return rcs.update(rc)

    def resize(self, namespace: str, name: str, new_size: int,
               preconditions: Optional[ResizePrecondition] = None,
               retry: Optional[RetryParams] = None,
               wait_for_replicas: Optional[RetryParams] = None,
               ) -> api.ReplicationController:
        """Retry conflicts (ref: resize.go ResizeCondition + RetryConflict);
        optionally wait until status catches up."""
        retry = retry or RetryParams()
        deadline = time.monotonic() + retry.timeout
        while True:
            try:
                rc = self.resize_simple(namespace, name, preconditions, new_size)
                break
            except errors.StatusError as e:
                if not errors.is_conflict(e) or time.monotonic() >= deadline:
                    raise
                time.sleep(retry.interval)
        if wait_for_replicas:
            rcs = self.client.resource("replicationcontrollers", namespace)
            deadline = time.monotonic() + wait_for_replicas.timeout
            while time.monotonic() < deadline:
                rc = rcs.get(name)
                if rc.status.replicas == rc.spec.replicas:
                    return rc
                time.sleep(wait_for_replicas.interval)
            raise TimeoutError(
                f"timed out waiting for {namespace}/{name} to reach "
                f"{new_size} replicas (at {rc.status.replicas})")
        return rc


class RCReaper:
    """ref: stop.go ReplicationControllerReaper — resize to 0, wait for the
    manager to delete the pods, then delete the RC."""

    def __init__(self, client, interval: float = 0.1, timeout: float = 30.0):
        self.client = client
        self.interval = interval
        self.timeout = timeout

    def stop(self, namespace: str, name: str) -> str:
        resizer = Resizer(self.client)
        resizer.resize(namespace, name, 0,
                       retry=RetryParams(self.interval, self.timeout),
                       wait_for_replicas=RetryParams(self.interval, self.timeout))
        self.client.resource("replicationcontrollers", namespace).delete(name)
        return f"{name} stopped"


class PodReaper:
    """Pods have no children; plain delete (ref: stop.go falls through to
    ObjectReaper/plain deletion for other kinds)."""

    def __init__(self, client):
        self.client = client

    def stop(self, namespace: str, name: str) -> str:
        self.client.resource("pods", namespace).delete(name)
        return f"{name} stopped"


class ServiceReaper:
    def __init__(self, client):
        self.client = client

    def stop(self, namespace: str, name: str) -> str:
        self.client.resource("services", namespace).delete(name)
        return f"{name} stopped"


def reaper_for(resource: str, client):
    """ref: stop.go ReaperFor."""
    if resource == "replicationcontrollers":
        return RCReaper(client)
    if resource == "pods":
        return PodReaper(client)
    if resource == "services":
        return ServiceReaper(client)
    raise ValueError(f"no reaper for resource {resource!r}")


class RollingUpdater:
    """ref: rolling_updater.go RollingUpdater.Update — one replica at a
    time: newRc +1, wait ready, oldRc -1, repeat; then delete oldRc
    (rolling_updater.go:144-145 — the new controller KEEPS its new name,
    as the update-demo transcript shows: `stop rc update-demo-kitten`).
    rename=True is an opt-in convenience for same-name image rolls."""

    def __init__(self, client, namespace: str,
                 sleep: Callable[[float], None] = time.sleep):
        self.client = client
        self.namespace = namespace
        self.sleep = sleep

    def update(self, old_name: str, new_rc: api.ReplicationController,
               update_period: float = 0.0, interval: float = 0.1,
               timeout: float = 60.0, rename: bool = False) -> api.ReplicationController:
        rcs = self.client.resource("replicationcontrollers", self.namespace)
        old_rc = rcs.get(old_name)
        if new_rc.metadata.name == old_name:
            raise ValueError("the new RC must have a different name")
        if new_rc.spec.selector == old_rc.spec.selector:
            raise ValueError("the new RC must have a different selector "
                             "(ref: rolling_updater.go validation)")
        desired = new_rc.spec.replicas or old_rc.spec.replicas
        new_rc.spec.replicas = 0
        new_rc.metadata.namespace = self.namespace
        try:
            created = rcs.create(new_rc)
        except errors.StatusError as e:
            if not errors.is_already_exists(e):
                raise
            created = rcs.get(new_rc.metadata.name)  # resume an interrupted update
        resizer = Resizer(self.client)
        wait = RetryParams(interval, timeout)
        while created.spec.replicas < desired or old_rc.spec.replicas > 0:
            if created.spec.replicas < desired:
                created = resizer.resize(
                    self.namespace, created.metadata.name,
                    created.spec.replicas + 1, wait_for_replicas=wait)
                if update_period:
                    self.sleep(update_period)
            if old_rc.spec.replicas > 0:
                old_rc = resizer.resize(
                    self.namespace, old_name,
                    old_rc.spec.replicas - 1, wait_for_replicas=wait)
        rcs.delete(old_name)
        if rename:
            # delete+recreate under the old name (ref: rolling_updater.go Rename)
            rcs.delete(created.metadata.name)
            created.metadata = api.ObjectMeta(
                name=old_name, namespace=self.namespace,
                labels=dict(created.metadata.labels))
            created = rcs.create(created)
        return created
