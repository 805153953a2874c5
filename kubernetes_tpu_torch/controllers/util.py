"""Shared periodic-runner helper for the control loops.

Port of ``kubernetes_tpu/controllers/util.py``.

Equivalent of the reference's ``util.Forever`` + ``HandleCrash`` idiom: run
an initial sync immediately (errors swallowed — the loop retries), then tick
on ``period`` until the stop event fires.
"""

from __future__ import annotations

import threading
from typing import Callable

__all__ = ["run_periodic"]


def run_periodic(fn: Callable[[], None], period: float, name: str,
                 stop: threading.Event) -> threading.Thread:
    def loop():
        # initial sync runs in the loop thread so a slow/hung API call can't
        # block the caller (ControllerManager.run starts five of these)
        while True:
            try:
                fn()
            except Exception:
                pass
            if stop.wait(period):
                return

    t = threading.Thread(target=loop, daemon=True, name=name)
    t.start()
    return t
