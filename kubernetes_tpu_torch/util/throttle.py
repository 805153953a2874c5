"""Token-bucket rate limiting.

Port of ``kubernetes_tpu/util/throttle.py``.

ref: pkg/util/throttle.go NewTokenBucketRateLimiter — bursts of up to
``burst`` may exceed the smoothed ``qps`` rate. The reference refills
from a ticker goroutine; here the refill is computed lazily from elapsed
time under the lock (no background thread to leak), which is equivalent:
tokens(t) = min(burst, tokens(t0) + (t - t0) * qps).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class TokenBucketRateLimiter:
    def __init__(self, qps: float, burst: int,
                 clock: Callable[[], float] = time.monotonic):
        if qps <= 0:
            raise ValueError("qps must be positive")
        if burst < 1:
            raise ValueError("burst must be a positive integer")
        self.qps = float(qps)
        self.burst = int(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = float(burst)   # starts full (throttle.go:61-63)
        self._last = clock()

    def can_accept(self) -> bool:
        """Take one token if available (throttle.go CanAccept — never
        blocks)."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.qps)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def retry_after_s(self) -> float:
        """Seconds until the next token becomes available, WITHOUT
        consuming one — the measured Retry-After hint for a 429 from
        this limiter (kube-fairshed replaced the hardcoded '1' sites
        with this; the hint is derived from the bucket's actual refill
        math, not a constant)."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.qps)
            self._last = now
            if self._tokens >= 1.0:
                return 0.0
            return (1.0 - self._tokens) / self.qps

    def stop(self) -> None:
        """No background resources; kept for interface parity
        (throttle.go Stop)."""
