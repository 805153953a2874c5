"""Watch primitives (ref: pkg/watch/).

Port of ``kubernetes_tpu/watch/__init__.py``'s ``Watcher`` and ``Event``:
the consumer handle of a watch stream (ref: watch.Interface — a result
channel plus Stop) that the reflector reads. The bounded-lag shedding and
the ``Broadcaster`` fan-out belong to the apiserver and are not ported.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Optional

__all__ = ["ADDED", "MODIFIED", "DELETED", "ERROR", "Event", "Watcher"]

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
ERROR = "ERROR"


@dataclass
class Event:
    type: str
    object: Any


_SENTINEL = object()


class Watcher:
    """A stream of watch Events, polled with next_event().

    ref: pkg/watch/watch.go Interface — ResultChan() + Stop().
    """

    def __init__(self, maxsize: int = 0, on_stop=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._stopped = threading.Event()
        self._on_stop = on_stop

    # producer side -------------------------------------------------------
    def send(self, event: Event, timeout: Optional[float] = None) -> bool:
        """Queue one event; False once the stream ended or the bounded
        queue stayed full for ``timeout``."""
        if self._stopped.is_set():
            return False
        try:
            self._q.put(event, timeout=timeout)
            return True
        except queue.Full:
            return False

    def close(self) -> None:
        """End of stream: consumers see None after draining."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        # never block: a full bounded queue would deadlock stop(); the
        # stream is ending, so one queued event may make room
        while True:
            try:
                self._q.put_nowait(_SENTINEL)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    # consumer side -------------------------------------------------------
    def stop(self) -> None:
        """Consumer is done (ref: watch.Interface.Stop)."""
        cb, self._on_stop = self._on_stop, None
        self.close()
        if cb:
            cb(self)

    def next_event(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event or None on end-of-stream; raises queue.Empty on
        timeout."""
        ev = self._q.get(timeout=timeout)
        if ev is _SENTINEL:
            self._q.put(_SENTINEL)  # keep the stream terminated for others
            return None
        return ev
