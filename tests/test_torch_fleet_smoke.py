"""chip_smoke.py's phase 14 at a small size, on the plain version.

(a) A kube-store process (a durable striped store), two apiserver worker
processes on one port sharing a segment, and the port's scheduler binary
in a thread: the store is SIGKILLed and respawned once a third of the
pending pods are bound, worker 0 once two thirds are; (b) a durable
apiserver alone, SIGKILLed and respawned on its port and directory once
half are bound. Each checks every pod bound exactly once within capacity,
every acknowledged write read back, the recovery disclosed, and each wave
against the plain version and solve(encode_snapshot(...)) of its state;
(a) also that both workers served, frame seeds crossed between them and
the shared ledger's backlog is 0. Launches are not counted here (the
plain version runs instead of the kernel); waves of 32 pods make several
waves of a few hundred pods, so each kill lands between two.
"""

import chip_smoke


def test_fleet_phase_rides_a_store_and_a_worker_kill():
    a = chip_smoke._fleet_phase("cpu", n_nodes=40, n_pending=300,
                                seeders=4, creators=2, wave_size=32,
                                count_launches=False)
    assert sum(w["bound"] for w in a["waves"]) >= 300
    assert set(a["kills"]) == {"kube-store", "worker0"}
    store = a["kills"]["kube-store"]
    assert store["recovery"]["replayed_records"] > 0
    assert store["recovery"]["index"] >= a["acked_rv_before_store_kill"]
    assert a["kills"]["kube-store"]["wave"] < a["kills"]["worker0"]["wave"]
    assert a["ledger"]["backlog"] == 0 and a["ledger"]["bound"] == 380
    assert a["wal"]["records_total"] > 0


def test_durable_phase_rides_an_apiserver_kill():
    b = chip_smoke._durable_phase("cpu", n_nodes=40, n_pending=200,
                                  seeders=4, creators=2, wave_size=32,
                                  count_launches=False)
    assert sum(w["bound"] for w in b["waves"]) >= 200
    rec = b["kills"]["apiserver"]["recovery"]
    assert rec["replayed_records"] > 0
    assert rec["index"] >= b["acked_rv_before_kill"]
    assert b["health"]["healthy"] is True


def test_remote_watch_open_reset_is_a_store_error():
    """A store that resets the watch handshake (dying, or just respawned)
    fails ``RemoteStore.watch`` with the store's own error, never a raw
    ConnectionResetError, which the apiserver would take for its client
    leaving."""
    import socket
    import struct
    import threading

    import pytest

    from kubernetes_tpu_torch.storage.memstore import StoreError
    from kubernetes_tpu_torch.storage.remote import RemoteStore

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)

    def reset_each():
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            conn.recv(1)  # the handshake arrived; answer with a reset
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
            conn.close()

    threading.Thread(target=reset_each, daemon=True).start()
    try:
        store = RemoteStore("127.0.0.1:%d" % lsock.getsockname()[1],
                            call_timeout_s=5.0, reconnect_window_s=1.0)
        with pytest.raises(StoreError, match="opening watch"):
            store.watch("/registry/pods", from_index=1)
    finally:
        lsock.close()


def test_http_watch_open_is_answered_when_the_store_resets():
    """A watch whose store call resets gets its connection closed, so the
    client's open fails at once instead of waiting for an answer the
    server will never send."""
    import http.client
    import threading

    from kubernetes_tpu_torch.apiserver.http import APIServer
    from kubernetes_tpu_torch.apiserver.master import Master, MasterConfig
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.storage.memstore import MemStore

    class Resetting(MemStore):
        def watch(self, *a, **kw):
            raise ConnectionResetError("reset by the store")

    srv = APIServer(Master(MasterConfig(store=Resetting()))).start()
    out: list = []

    def open_watch():
        try:
            Client(HTTPTransport(srv.base_url)).pods("").watch(
                resource_version="1")
            out.append("opened")
        except (OSError, http.client.HTTPException) as e:
            out.append(type(e).__name__)

    try:
        th = threading.Thread(target=open_watch, daemon=True)
        th.start()
        th.join(timeout=20)
        assert not th.is_alive(), "the watch open waited for an answer"
        assert out and out[0] != "opened", out
    finally:
        srv.stop()


class _Queue:
    """``next_pod`` over a fixed sequence of pods, then a timeout: a
    wave drain whose queue hands out a pod again (a relist re-adds every
    unbound pod, the ones just popped too)."""

    def __init__(self, pods):
        self.pods = list(pods)

    def next_pod(self, timeout=None):
        if not self.pods:
            raise TimeoutError
        return self.pods.pop(0)


def _drained(pkg: str, seq):
    import importlib
    import types

    tb = importlib.import_module(f"{pkg}.scheduler.tpu_batch")
    api = importlib.import_module(f"{pkg}.api.types")
    pods = [api.Pod(metadata=api.ObjectMeta(
        name=name, namespace="default", resource_version=str(rv)))
        for name, rv in seq]
    sched = object.__new__(tb.BatchScheduler)
    sched.config = types.SimpleNamespace(next_pod=_Queue(pods).next_pod)
    sched.wave_size, sched.wave_linger_s = 8, 1.0
    return [(p.metadata.name, p.metadata.resource_version)
            for p in sched._drain_wave(0)]


def test_a_pod_queued_again_while_a_wave_drains_is_placed_once():
    """ROADMAP Queue 3: the durable-kill phase's "acknowledged binds do
    not read back". After the apiserver's respawn the
    scheduler's reflector relists and re-adds every unbound pod to the
    queue while a wave drains, so the wave held a pod twice; the solve
    placed both copies, the first bind won, the second answered 409, and
    the check, keying the wave's acknowledgements by name, took the
    losing copy's host. The reference drains the pod twice; the port
    keeps it once, its newer copy in the first one's place. (The check
    now counts an acknowledgement per bind entry.)"""
    seq = [("a", 1), ("b", 2), ("a", 3), ("c", 4)]
    assert _drained("kubernetes_tpu", seq) == [
        ("a", "1"), ("b", "2"), ("a", "3"), ("c", "4")]
    assert _drained("kubernetes_tpu_torch", seq) == [
        ("a", "3"), ("b", "2"), ("c", "4")]


def _relisted(pkg: str):
    """A wave's acknowledged bind of ``a`` is assumed, then a relist
    whose list was taken before the bind landed queues ``a`` again with
    ``q`` -> (the pods the modeler holds with their hosts, the pods the
    queue then hands out)."""
    import importlib

    driver = importlib.import_module(f"{pkg}.scheduler.driver")
    api = importlib.import_module(f"{pkg}.api.types")

    def pod(name, host=""):
        return api.Pod(metadata=api.ObjectMeta(
            name=name, namespace="default", uid=f"uid-{name}"),
            spec=api.PodSpec(host=host))
    factory = driver.ConfigFactory(client=None)
    factory.modeler.assume_pod(pod("a", "n1"))
    factory.pod_queue.replace([pod("a"), pod("q")])
    held = sorted((p.metadata.name, p.spec.host)
                  for p in factory.modeler.list())
    popped = []
    while True:
        try:
            popped.append(factory._next_pod(0).metadata.name)
        except TimeoutError:
            return held, popped


def test_a_relist_does_not_undo_an_acknowledged_bind():
    """ROADMAP Queue 3, the same flake's other half: after the
    apiserver's respawn the first wave bound pods that the unassigned
    pods' relist, listed just before, queued again. The reference's
    modeler takes a queued copy for a failed bind and drops the
    assumption (the encoder forgets the pod's share of its node) and the
    queue hands the pod out to be placed again (its bind answers 409);
    the port keeps the assumption and drops the stale copy."""
    assert _relisted("kubernetes_tpu") == ([], ["a", "q"])
    assert _relisted("kubernetes_tpu_torch") == ([("a", "n1")], ["q"])
