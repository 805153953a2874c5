"""Capped exponential backoff with jitter (port of
``kubernetes_tpu/util/retry.py``): the reflector's retry discipline after
a failed list or watch and the HTTP transport's connect window —
exponentially growing, jittered, capped delays, reset on success."""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

__all__ = ["Backoff"]


class Backoff:
    """``next()`` returns the next delay (seconds) and advances;
    ``reset()`` on success. The delay for attempt k is
    ``min(cap, base * factor**k)`` scaled by a uniform jitter in
    ``[1 - jitter, 1 + jitter]``.

    ``rng`` and ``sleep`` are injectable so tests run deterministic and
    clockless; production call sites take the defaults."""

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 factor: float = 2.0, jitter: float = 0.25,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if not (base > 0 and cap >= base and factor >= 1.0
                and 0.0 <= jitter < 1.0):
            raise ValueError(f"bad backoff {base}, {cap}, {factor}, {jitter}")
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def reset(self) -> None:
        self._attempt = 0

    def peek(self) -> float:
        """The un-jittered delay the next ``next()`` would scale."""
        return min(self.cap, self.base * (self.factor ** self._attempt))

    def next(self) -> float:
        raw = self.peek()
        self._attempt += 1
        if self.jitter:
            raw *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return raw

    def sleep_next(self) -> float:
        """Sleep the next delay; returns the delay actually slept."""
        d = self.next()
        self._sleep(d)
        return d
