"""The storage tier's bytes are the reference's, both ways.

Each case runs the JAX package's module and the port's on the CPU, each
on what the other wrote or served:

- a data directory written by one package's ``DurableStore`` or
  ``DurableStripedStore`` recovers in the other's ``DurableStore`` and
  ``DurableStripedStore`` with the same index, keys, values, created and
  modified indices and watch history, TTL deadlines within 1 s; the same
  operations under the same clocks write the same ``wal.log`` and
  ``snapshot.json`` bytes;
- a torn or corrupt WAL tail is truncated to the same byte, with the
  same disclosure;
- ``shard_of_key`` agrees on a seeded set of keys for S = 1, 2, 4, 8;
- one package's ``RemoteStore`` against the other's ``StoreServer``
  gives every verb's result and error class, and a watch's events, as
  each package's own store does in process;
- a share segment created by one package is attached by the other,
  which reads its ledger totals and imports its frames bit-identical,
  and an apiserver of one package imports a sibling of the other's seeded
  encoding as its own bytes.
"""

import importlib
import json
import os
import queue
import shutil

import numpy as np
import pytest

PKGS = {"ref": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}
OTHER = {"ref": "port", "port": "ref"}
T0_MONO, T0_WALL = 5_000.0, 1_700_000_000.0


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _durable(pkg, kind, directory, **kw):
    if kind == "durable":
        return _mod(pkg, "storage.durable").DurableStore(directory, **kw)
    return _mod(pkg, "storage.stripestore").DurableStripedStore(
        directory, shards=4, **kw)


def _frozen():
    return {"clock": lambda: T0_MONO, "wall_clock": lambda: T0_WALL}


def _workload(store, seed=7, n=160, compact_at=90):
    """Seeded creates, sets, CAS, deletes, TTLs, a CAS batch and evict+bind
    transactions over keys in five namespaces, with one compaction half
    way so recovery reads a snapshot and a WAL."""
    rng = np.random.default_rng(seed)
    live = {}
    for step in range(n):
        ns = f"ns{int(rng.integers(5))}"
        key = f"/registry/pods/{ns}/p{int(rng.integers(40))}"
        op = int(rng.integers(6))
        if key not in live:
            ttl = float(rng.integers(30, 300)) if op == 5 else None
            live[key] = store.create(key, f"v{step}", ttl=ttl).modified_index
        elif op == 0:
            store.delete(key)
            del live[key]
        elif op in (1, 5):
            live[key] = store.set(key, f"s{step}").modified_index
        elif op == 2:
            live[key] = store.compare_and_swap(
                key, f"c{step}", live[key]).modified_index
        elif op == 3:
            keys = sorted(live)[:3]
            out = store.compare_and_swap_many(
                [(k, f"m{step}", live[k]) for k in keys])
            for k, r in zip(keys, out):
                live[k] = r.modified_index
        else:
            victim = next((k for k in sorted(live) if k != key), None)
            if victim is None:
                continue
            store.txn_many([([(key, f"b{step}", live[key])],
                             [(victim, live[victim])])])
            live[key] = store.get(key).modified_index
            del live[victim]
        if step == compact_at:
            store.compact()
    store.create("/registry/nodes/n1", "node")
    store.create("/registry/events/e1", "ev", ttl=120.0)


def _dump(store):
    """(index, [(key, value, created, modified, ttl left)], history)"""
    kvs, _ = store.list("/")
    now = store._clock()
    rows = [(kv.key, kv.value, kv.created_index, kv.modified_index,
             None if kv.expiration is None else kv.expiration - now)
            for kv in kvs]
    w = store.watch("/", from_index=1)
    hist = []
    while True:
        try:
            o = w.next_event(timeout=0.05).object
        except queue.Empty:
            break
        hist.append((o.action, o.key, o.index,
                     None if o.kv is None else o.kv.value,
                     None if o.prev_kv is None else o.prev_kv.value))
    w.stop()
    return store.index, rows, hist


def _assert_same(got, want):
    (gi, grows, ghist), (wi, wrows, whist) = got, want
    assert gi == wi
    assert [r[:4] for r in grows] == [r[:4] for r in wrows]
    for g, w in zip(grows, wrows):
        assert (g[4] is None) == (w[4] is None), g
        if g[4] is not None:
            assert abs(g[4] - w[4]) < 1.0, (g, w)
    assert ghist == whist


@pytest.mark.parametrize("reader_kind", ["durable", "striped"])
@pytest.mark.parametrize("writer_kind", ["durable", "striped"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_data_dir_recovers_in_the_other_package(writer, writer_kind,
                                                reader_kind, tmp_path):
    src = str(tmp_path / "src")
    store = _durable(writer, writer_kind, src)
    _workload(store)
    want = _dump(store)
    assert len(want[2]) > 100  # the watch window spans the compaction
    reader = OTHER[writer]
    for pkg in (writer, reader):
        dst = str(tmp_path / f"{pkg}-{reader_kind}")
        shutil.copytree(src, dst)
        got = _durable(pkg, reader_kind, dst)
        assert got.recovery["replayed_records"] > 0
        assert got.recovery["torn_bytes"] == 0
        _assert_same(_dump(got), want)


@pytest.mark.parametrize("kind", ["durable", "striped"])
def test_same_operations_write_the_same_bytes(kind, tmp_path):
    files = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        store = _durable(pkg, kind, d, **_frozen())
        _workload(store)
        store._wal_f.flush()
        files[pkg] = {f: open(os.path.join(d, f), "rb").read()
                      for f in ("wal.log", "snapshot.json")}
    assert files["ref"]["wal.log"]  # records after the compaction
    assert files["ref"] == files["port"]
    if kind == "striped":
        assert b'"s": ' in files["port"]["wal.log"]


_TAILS = {
    # a crash mid-append: half a record, no newline
    "torn": b'{"a": "set", "k": "/registry/pods/ns0/p1", "i": 99',
    # a corrupt line with a parseable record after it
    "midfile": b'{"a": "set", "k": \n'
               b'{"a": "delete", "k": "/registry/pods/ns0/zz", "i": 999}\n',
}


@pytest.mark.parametrize("tail", sorted(_TAILS))
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_torn_tail_truncates_to_the_same_byte(writer, tail, tmp_path):
    src = str(tmp_path / "src")
    store = _durable(writer, "durable", src)
    _workload(store, n=40, compact_at=-1)
    store._wal_f.flush()
    good = os.path.getsize(os.path.join(src, "wal.log"))
    with open(os.path.join(src, "wal.log"), "ab") as f:
        f.write(_TAILS[tail])
    want = _dump(store)
    seen = set()
    for pkg in PKGS:
        for kind in ("durable", "striped"):
            dst = str(tmp_path / f"{pkg}-{kind}")
            shutil.copytree(src, dst)
            got = _durable(pkg, kind, dst)
            size = os.path.getsize(os.path.join(dst, "wal.log"))
            seen.add((size, got.recovery["torn_bytes"]))
            _assert_same(_dump(got), want)
    assert seen == {(good, len(_TAILS[tail]))}


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_shard_of_key_agrees(shards):
    ref = _mod("ref", "storage.stripestore").shard_of_key
    port = _mod("port", "storage.stripestore").shard_of_key
    rng = np.random.default_rng(shards)
    keys = ["", "/", "/registry", "/registry/nodes", "/registry/pods/ns",
            "/registry/pods/ns/", "/a/b/c/d/e", "/registry/pods/é/ü",
            "registry//pods//x"]
    for _ in range(500):
        parts = ["".join(chr(int(c)) for c in rng.integers(97, 123, size=int(
            rng.integers(1, 9)))) for _ in range(int(rng.integers(1, 6)))]
        keys.append("/" + "/".join(parts))
    got = [port(k, shards) for k in keys]
    assert got == [ref(k, shards) for k in keys]
    if shards > 1:
        assert len(set(got)) == shards


def _verbs(store, pkg):
    """Every verb of the store contract on one store: results as plain
    tuples, errors as the class name (an error must be the client
    package's own class)."""
    err_base = _mod(pkg, "storage.memstore").StoreError
    out = []

    def kv(x):
        return None if x is None else (x.key, x.value, x.created_index,
                                       x.modified_index)

    def run(name, fn):
        try:
            r = fn()
        except err_base as e:
            out.append((name, "raised", type(e).__name__))
            return None
        out.append((name, r))
        return r

    a = run("create", lambda: kv(store.create("/c/ns/a", "1")))
    run("create-dup", lambda: kv(store.create("/c/ns/a", "x")))
    b = run("create-b", lambda: kv(store.create("/c/other/b", "2")))
    run("get", lambda: kv(store.get("/c/ns/a")))
    run("get-missing", lambda: kv(store.get("/c/ns/none")))
    run("get_many", lambda: [kv(x) for x in store.get_many(
        ["/c/ns/a", "/c/ns/none", "/c/other/b"])])
    run("set", lambda: kv(store.set("/c/ns/a", "3")))
    run("cas-conflict", lambda: kv(store.compare_and_swap(
        "/c/ns/a", "4", a[3])))
    a2 = store.get("/c/ns/a").modified_index
    run("cas", lambda: kv(store.compare_and_swap("/c/ns/a", "5", a2)))
    run("cas_many", lambda: [kv(x) if not isinstance(x, Exception)
                             else type(x).__name__
                             for x in store.compare_and_swap_many(
                                 [("/c/ns/a", "6", a2),
                                  ("/c/other/b", "7", b[3])])])
    run("list", lambda: ([kv(x) for x in store.list("/c")[0]],
                         store.list("/c")[1]))
    run("delete-stale", lambda: kv(store.delete("/c/other/b",
                                                 prev_index=b[3] - 1)))
    run("txn_many", lambda: [
        type(x).__name__ if isinstance(x, Exception) else
        [kv(y) for y in x] if isinstance(x, list) else x
        for x in store.txn_many([
            ([("/c/ns/a", "8", store.get("/c/ns/a").modified_index)],
             [("/c/other/b", store.get("/c/other/b").modified_index)])])])
    run("delete", lambda: kv(store.delete("/c/ns/a")))
    run("delete-missing", lambda: kv(store.delete("/c/ns/a")))
    run("index", lambda: store.index)
    last = store.index
    w = store.watch("/c", from_index=1)
    events = []
    while not events or events[-1][2] < last:
        ev = w.next_event(timeout=5.0)
        events.append((ev.type, ev.object.key, ev.object.index))
    w.stop()
    out.append(("watch", events))
    for i in range(_mod(pkg, "storage.memstore").MemStore.HISTORY_WINDOW
                   + 5):
        store.set("/h/k", str(i))
    run("watch-outdated", lambda: store.watch("/h", from_index=1) and None)
    return out


@pytest.mark.parametrize("client", ["ref", "port"])
def test_remote_store_talks_to_the_other_server(client):
    server_pkg = OTHER[client]
    server = _mod(server_pkg, "storage.remote").StoreServer().start()
    remote = _mod(client, "storage.remote").RemoteStore(server.address)
    try:
        got = _verbs(remote, client)
    finally:
        server.stop()
    for pkg in PKGS:
        assert got == _verbs(_mod(pkg, "storage.memstore").MemStore(), pkg)
    raised = {name: cls for name, *rest in got if len(rest) == 2
              for _, cls in [rest]}
    assert raised == {"create-dup": "ErrKeyExists",
                      "get-missing": "ErrKeyNotFound",
                      "cas-conflict": "ErrCASConflict",
                      "delete-stale": "ErrCASConflict",
                      "delete-missing": "ErrKeyNotFound",
                      "watch-outdated": "ErrIndexOutdated"}


def test_segments_of_both_packages_are_the_same_bytes(tmp_path):
    blobs = []
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg}.seg")
        share = _mod(pkg, "apiserver.share")
        seg = share.ShareSegment.create(path, 3, ring_bytes=4096,
                                        worker_index=1)
        ledger = share.SharedLedger(seg)
        for _ in range(5):
            ledger.note_created()
        ledger.note_bound(2)
        ledger.note_deleted()
        for i in range(30):  # wraps the 4 KiB ring
            seg.publish_frame(f"{i}", "v1", json.dumps({"i": i, "é": "x" * 90}))
        seg.close()
        blobs.append(open(path, "rb").read())
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("creator", ["ref", "port"])
def test_share_segment_is_attached_by_the_other_package(creator, tmp_path):
    path = str(tmp_path / "share.seg")
    mine = _mod(creator, "apiserver.share")
    theirs = _mod(OTHER[creator], "apiserver.share")
    a = mine.ShareSegment.create(path, 2, ring_bytes=8192, worker_index=0)
    b = theirs.ShareSegment(path, worker_index=1)
    try:
        la, lb = mine.SharedLedger(a), theirs.SharedLedger(b)
        for _ in range(9):
            la.note_created()
        lb.note_bound(4)
        lb.note_deleted()
        assert la.backlog() == lb.backlog() == 4
        assert a.worker_counters(1) == b.worker_counters(1)
        pub = [(f"{100 + i}", "v1", json.dumps({"kind": "Pod", "i": i,
                                                "pad": "é" * 30}))
               for i in range(40)]  # wraps the ring for a keeping-up reader
        got_b, got_a = [], []
        for rv, ver, wire in pub:
            assert a.publish_frame(rv, ver, wire)
            assert b.publish_frame(rv + "b", ver, wire)
            got_b += b.drain_frames()
            got_a += a.drain_frames()
        assert got_b == pub
        assert got_a == [(rv + "b", ver, wire) for rv, ver, wire in pub]
        assert a.ring_drops == b.ring_drops == 0
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_apiserver_imports_the_other_packages_seed(writer, tmp_path):
    """Two workers of a fleet, one of each package, on one kube-store and
    one segment: the writer's seeded encoding of a created pod is what the
    sibling imports, and it is byte for byte what the sibling encodes for
    the same revision itself."""
    reader = OTHER[writer]
    path = str(tmp_path / "share.seg")
    _mod(writer, "apiserver.share").ShareSegment.create(path, 2)
    store_srv = _mod("port", "storage.remote").StoreServer().start()
    servers = {}
    try:
        for i, pkg in enumerate((writer, reader)):
            master = _mod(pkg, "apiserver.master")
            seg = _mod(pkg, "apiserver.share").ShareSegment(
                path, worker_index=i)
            store = _mod(pkg, "storage.remote").RemoteStore(
                store_srv.address)
            servers[pkg] = _mod(pkg, "apiserver.http").APIServer(
                master.Master(master.MasterConfig(store=store)),
                share=seg).start()
        api = _mod(writer, "api.types")
        client = _mod(writer, "client.client").Client(
            _mod(writer, "client.http").HTTPTransport(
                servers[writer].base_url))
        pod = client.pods().create(api.Pod(
            metadata=api.ObjectMeta(name="seeded", namespace="default"),
            spec=api.PodSpec(containers=[api.Container(name="c",
                                                       image="img")])))
        rv = pod.metadata.resource_version
        sib = servers[reader]
        sib._drain_share_seeds()
        assert sib.metric_seed_imported.value() >= 1
        imported = sib._wire_cache[(rv, "v1")]
        assert imported == servers[writer]._wire_cache[(rv, "v1")]
        rapi = _mod(reader, "api.types")
        rclient = _mod(reader, "client.client").Client(
            _mod(reader, "client.http").HTTPTransport(sib.base_url))
        own = rclient.pods().get("seeded")
        assert isinstance(own, rapi.Pod)
        assert sib.scheme.encode(own, "v1") == imported
    finally:
        for srv in servers.values():
            srv.stop()
            srv.share.close()
        store_srv.stop()
