"""The port's HTTP layer (apiserver/http.py) on every case of
tests/test_http.py, through the port's ``HTTPTransport``: REST routes,
chunked watch streaming, the hand-rolled request-line and header parser,
authentication and ABAC, CORS, the read-only port and its rate limiter,
the encode-once watch fan-out with its lag bound, ``bindings:batch``, and
the legacy v1beta1 wire's flat encoding.

The slow-watcher case is the reference's with one change that makes it
deterministic: the "fast" watcher reads each event before the next
create, so its queue never nears the lag bound however loaded the host
is (the reference's fast watcher, 40 creates behind, can itself be
dropped to resync when its writer thread is starved).
"""

import json

from test_torch_twin import port_twin

globals().update(port_twin("test_http"))


def _wait_watchers(srv, n, timeout=10.0):
    """Until the server tracks ``n`` watch streams."""
    import time
    deadline = time.monotonic() + timeout
    while len(srv._watchers) < n:
        assert time.monotonic() < deadline, len(srv._watchers)
        time.sleep(0.005)


def _slow_watcher_drops_to_resync_fast_watcher_unaffected(self):
    from kubernetes_tpu_torch.util import chaos
    from kubernetes_tpu_torch.util import metrics as metrics_pkg

    srv = APIServer(Master(MasterConfig()), watch_lag_limit=8).start()
    client = Client(HTTPTransport(srv.base_url))
    resyncs0 = metrics_pkg.default_registry().counter(
        "watch_lag_resyncs_total").total()
    slow = fast = None
    try:
        chaos.inject_gate("apiserver.watch.write.lagger")
        slow = _RawWatch(
            srv.port, path="/api/v1/pods?watch=1&chaosGate=lagger")
        fast = _RawWatch(srv.port)
        _wait_watchers(srv, 2)
        fast_frames = []
        for i in range(40):
            client.pods().create(make_pod(f"lag-{i:03d}"))
            fast_frames.append(fast.read_frame(timeout=30))
        assert metrics_pkg.default_registry().counter(
            "watch_lag_resyncs_total").total() > resyncs0
        assert all(f is not None for f in fast_frames)
        assert [json.loads(f)["object"]["metadata"]["name"]
                for f in fast_frames] == [f"lag-{i:03d}" for i in range(40)]
        chaos.release_gate("apiserver.watch.write.lagger")
        frames = []
        while True:
            f = slow.read_frame(timeout=10)
            if f is None:
                break
            frames.append(f)
        last = json.loads(frames[-1])
        assert last["type"] == "ERROR"
        assert last["object"]["code"] == 410
        assert last["object"]["reason"] == "Expired"
        assert srv.metric_watch_lag_drops.total() >= 1
        assert len(client.pods().list().items) == 40
    finally:
        chaos.clear()
        if slow is not None:
            slow.close()
        if fast is not None:
            fast.close()
        srv.stop()


TestWatchFanout.test_slow_watcher_drops_to_resync_fast_watcher_unaffected = \
    _slow_watcher_drops_to_resync_fast_watcher_unaffected
