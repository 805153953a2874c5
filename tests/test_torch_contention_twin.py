"""tests/test_contention.py against the port: optimistic-concurrency
conflicts between schedulers on one apiserver. Nothing is left out."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_contention"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)


def test_stop_never_joins_a_requeue_thread_before_it_starts(monkeypatch):
    """The error handler registers its backoff-requeue thread and starts
    it under one lock, so a ``stop()`` racing it joins only started
    threads (the reference starts the thread after releasing the lock,
    and ``stop()`` between the two raised "cannot join thread before it
    is started" in a run of this file's race case)."""
    import threading
    import time
    import types

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.client import FakeClient
    from kubernetes_tpu_torch.scheduler import driver

    go = threading.Event()

    class SlowStart(threading.Thread):
        def start(self):
            go.wait(5)
            super().start()

    factory = driver.ConfigFactory(FakeClient())
    handle = factory._make_error_func()
    # the handler's threads start late; nothing else of the module moves
    monkeypatch.setattr(driver, "threading",
                        types.SimpleNamespace(Thread=SlowStart))
    pod = api.Pod(metadata=api.ObjectMeta(name="p", namespace="default"))
    h = threading.Thread(target=handle, args=(pod, RuntimeError("x")),
                         daemon=True)
    h.start()
    deadline = time.monotonic() + 5
    while not factory._requeue_threads and time.monotonic() < deadline:
        time.sleep(0.001)
    assert factory._requeue_threads, "the handler never registered"
    threading.Timer(0.2, go.set).start()
    factory.stop()
    h.join(5)
    assert not h.is_alive()
