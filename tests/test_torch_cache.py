"""The port's client cache and modeler changelog against the JAX package's.

Every test runs once over each package (``pkg`` is the JAX package's
modules or the port's): Store, FIFO, Reflector, Poller and the listers
(mirroring tests/test_cache.py, with a scripted list-watch source in place
of the apiserver's storage), and the Store changelog with
SimpleModeler.token/delta (mirroring tests/test_incremental.py's changelog
test). A seeded sequence of store and modeler operations then goes
through both packages at once, and every ``delta`` must name the same
pods (by uid, in order) and every ``list`` the same set.
"""

import random
import threading
import time
from types import SimpleNamespace

import pytest

from kubernetes_tpu import watch as ref_watch
from kubernetes_tpu.api import labels as ref_labels
from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.client import cache as ref_cache
from kubernetes_tpu.scheduler import driver as ref_driver
from kubernetes_tpu_torch import watch as port_watch
from kubernetes_tpu_torch.api import labels as port_labels
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.client import cache as port_cache
from kubernetes_tpu_torch.scheduler import driver as port_driver

REF = SimpleNamespace(name="ref", api=ref_api, cache=ref_cache,
                      driver=ref_driver, watch=ref_watch, labels=ref_labels)
PORT = SimpleNamespace(name="port", api=port_api, cache=port_cache,
                       driver=port_driver, watch=port_watch,
                       labels=port_labels)


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


def _pod(pkg, name, ns="default", labels=None, host="", uid=None):
    api = pkg.api
    return api.Pod(metadata=api.ObjectMeta(name=name, namespace=ns,
                                           uid=uid or f"uid-{name}",
                                           labels=labels or {}),
                   spec=api.PodSpec(host=host),
                   status=api.PodStatus(host=host))


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


class _Source:
    """A pods list-watch over a dict: list at the current resource
    version; every open watch gets each later change."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.lock = threading.Lock()
        self.objs = {}
        self.rv = 0
        self.watchers = []

    def list_watch(self):
        return self.pkg.cache.ListWatch(self.list_fn, self.watch_fn)

    def list_fn(self):
        api = self.pkg.api
        with self.lock:
            return api.PodList(items=list(self.objs.values()),
                               metadata=api.ListMeta(
                                   resource_version=str(self.rv)))

    def watch_fn(self, rv):
        w = self.pkg.watch.Watcher()
        with self.lock:
            self.watchers.append(w)
        return w

    def _emit(self, typ, pod):
        with self.lock:
            self.rv += 1
            pod.metadata.resource_version = str(self.rv)
            if typ == self.pkg.watch.DELETED:
                self.objs.pop(pod.metadata.name, None)
            else:
                self.objs[pod.metadata.name] = pod
            watchers = list(self.watchers)
        for w in watchers:
            w.send(self.pkg.watch.Event(typ, pod))

    def create(self, pod):
        self._emit(self.pkg.watch.ADDED, pod)

    def update(self, pod):
        self._emit(self.pkg.watch.MODIFIED, pod)

    def delete(self, pod):
        self._emit(self.pkg.watch.DELETED, pod)


# -- Store / FIFO (tests/test_cache.py) --------------------------------------

def test_store_basics(pkg):
    s = pkg.cache.Store()
    s.add(_pod(pkg, "a"))
    s.add(_pod(pkg, "b"))
    assert len(s) == 2
    assert s.get_by_key("default/a").metadata.name == "a"
    s.delete(_pod(pkg, "a"))
    assert s.get_by_key("default/a") is None
    s.replace([_pod(pkg, "x")])
    assert s.list_keys() == ["default/x"]


def test_fifo_coalesces_updates(pkg):
    f = pkg.cache.FIFO()
    f.add(_pod(pkg, "a"))
    f.add(_pod(pkg, "a", host="updated"))  # same key: keeps its position
    f.add(_pod(pkg, "b"))
    first = f.pop()
    assert first.metadata.name == "a" and first.spec.host == "updated"
    assert f.pop().metadata.name == "b"


def test_fifo_pop_blocks_until_add_and_times_out(pkg):
    f = pkg.cache.FIFO()
    with pytest.raises(TimeoutError):
        f.pop(timeout=0.02)
    got = []
    t = threading.Thread(target=lambda: got.append(f.pop(timeout=5)))
    t.start()
    time.sleep(0.05)
    assert not got
    f.add(_pod(pkg, "late"))
    t.join(timeout=5)
    assert not t.is_alive()
    assert got and got[0].metadata.name == "late"


def test_fifo_delete_skipped_by_pop(pkg):
    f = pkg.cache.FIFO()
    f.add(_pod(pkg, "a"))
    f.add(_pod(pkg, "b"))
    f.delete(_pod(pkg, "a"))
    assert f.pop().metadata.name == "b"
    assert len(f) == 0


def test_listers(pkg):
    api = pkg.api
    pods = pkg.cache.Store()
    pods.add(_pod(pkg, "a", labels={"app": "web"}))
    pods.add(_pod(pkg, "b", labels={"app": "db"}))
    lister = pkg.cache.StorePodLister(pods)
    assert {p.metadata.name for p in lister.list()} == {"a", "b"}
    sel = pkg.labels.selector_from_set({"app": "web"})
    assert [p.metadata.name for p in lister.list(sel)] == ["a"]
    services = pkg.cache.Store()
    for name, ns in (("web", "default"), ("all", "other")):
        services.add(api.Service(
            metadata=api.ObjectMeta(name=name, namespace=ns),
            spec=api.ServiceSpec(port=80, selector={"app": "web"})))
    got = pkg.cache.StoreServiceLister(services).get_pod_services(
        _pod(pkg, "a", labels={"app": "web"}))
    assert [s.metadata.name for s in got] == ["web"]  # namespace-scoped
    nodes = pkg.cache.Store()
    nodes.add(api.Node(metadata=api.ObjectMeta(name="n1")))
    assert [n.metadata.name for n in
            pkg.cache.StoreNodeLister(nodes).list().items] == ["n1"]


# -- Reflector / Poller -------------------------------------------------------

def test_reflector_mirrors_source_and_freezes_on_join(pkg):
    src = _Source(pkg)
    src.create(_pod(pkg, "pre"))
    store = pkg.cache.Store()
    r = pkg.cache.Reflector(src.list_watch(), store, name="pods").run()
    try:
        assert _wait_for(lambda: store.get_by_key("default/pre") is not None
                         and src.watchers)
        src.create(_pod(pkg, "live"))
        assert _wait_for(lambda: store.get_by_key("default/live")
                         is not None)
        src.update(_pod(pkg, "live", host="n1"))
        assert _wait_for(lambda: store.get_by_key("default/live")
                         .spec.host == "n1")
        src.delete(store.get_by_key("default/pre"))
        assert _wait_for(lambda: store.get_by_key("default/pre") is None)
        assert r.last_sync_resource_version == str(src.rv)
    finally:
        r.stop()
    assert r.join(5.0), "reflector thread did not exit"
    src.create(_pod(pkg, "late"))
    assert store.get_by_key("default/late") is None
    assert pkg.cache.Reflector(src.list_watch(), pkg.cache.Store()).join(0.1)


def test_reflector_into_fifo_survives_watch_closure(pkg):
    """The scheduler's pattern (unassigned pods -> FIFO, factory.go:126);
    a stream the server closes resumes without losing events."""
    src = _Source(pkg)
    fifo = pkg.cache.FIFO()
    r = pkg.cache.Reflector(src.list_watch(), fifo, name="unassigned").run()
    try:
        assert _wait_for(lambda: src.watchers)
        src.create(_pod(pkg, "w1"))
        assert fifo.pop(timeout=5).metadata.name == "w1"
        n = len(src.watchers)
        src.watchers[-1].close()
        assert _wait_for(lambda: len(src.watchers) > n)
        src.create(_pod(pkg, "w2"))
        assert fifo.pop(timeout=5).metadata.name == "w2"
    finally:
        r.stop()
        assert r.join(5.0)


def test_poller_replaces(pkg):
    api = pkg.api
    calls = []

    def list_fn():
        calls.append(1)
        return api.PodList(items=[_pod(pkg, f"p{len(calls)}")])

    store = pkg.cache.Store()
    p = pkg.cache.Poller(list_fn, period=0.02, store=store).run()
    try:
        assert _wait_for(lambda: len(calls) >= 3)
        assert len(store) == 1
    finally:
        p.stop()
        assert p.join(5.0)


# -- the changelog (tests/test_incremental.py:424) ---------------------------

def test_store_changelog_and_modeler_delta(pkg):
    cache = pkg.cache
    s = cache.Store()
    t0 = s.token()
    a, b = _pod(pkg, "a"), _pod(pkg, "b")
    s.add(a)
    s.add(b)
    s.delete(a)
    events, t1 = s.delta_since(t0)
    assert [op for op, _ in events] == ["set", "set", "delete"]
    assert s.delta_since(t1) == ([], t1)
    # a relist diffs against the cache: identical contents log nothing,
    # a vanished object logs a delete
    s.replace([b])
    assert s.delta_since(t1) == ([], t1)
    s.replace([])
    events, _t2 = s.delta_since(t1)
    assert [(op, o.metadata.name) for op, o in events] == [("delete", "b")]
    # only a diff wider than the retained window breaks tokens
    s.add(b)
    t3 = s.token()
    orig = cache.Store._LOG_MAX
    try:
        cache.Store._LOG_MAX = 1
        s.replace([_pod(pkg, "c"), _pod(pkg, "d")])
    finally:
        cache.Store._LOG_MAX = orig
    assert s.delta_since(t3) is None

    m = pkg.driver.SimpleModeler(cache.FIFO(), cache.Store())
    tok = m.token()
    p = _pod(pkg, "p1", host="n1")
    m.assume_pod(p)
    ups, rms, tok = m.delta(tok)
    assert [x.metadata.name for x in ups] == ["p1"] and rms == []
    # the reflector catches the bind: assumed -> scheduled is a migration
    m.scheduled.add(p)
    ups, rms, tok = m.delta(tok)
    assert rms == [] and [x.metadata.name for x in ups] == ["p1"]
    m.scheduled.delete(p)
    ups, rms, tok = m.delta(tok)
    assert ups == [] and [x.metadata.name for x in rms] == ["p1"]
    # delete + recreate of one name with a new uid inside one window
    old = _pod(pkg, "p2", uid="uid-old")
    m.scheduled.add(old)
    ups, rms, tok = m.delta(tok)
    m.scheduled.delete(old)
    m.scheduled.add(_pod(pkg, "p2", uid="uid-new"))
    ups, rms, tok = m.delta(tok)
    assert [x.metadata.uid for x in ups] == ["uid-new"]
    assert [x.metadata.uid for x in rms] == ["uid-old"]


def _drop_stale_copies(m) -> None:
    """The port modeler's one rule beyond the reference's, applied to a
    reference modeler: a queued copy of a pod assumed under its own uid
    is a relist's stale copy and leaves the queue (the reference takes
    it for a failed bind and drops the assumption; ROADMAP Queue 3). Each
    package's own behaviour is held by test_torch_fleet_smoke.py's
    test_a_relist_does_not_undo_an_acknowledged_bind."""
    for pod in m.assumed.list():
        queued = m.queued.get_by_key(f"default/{pod.metadata.name}")
        if queued is not None and queued.metadata.uid == pod.metadata.uid:
            m.queued.delete(queued)


@pytest.mark.parametrize("seed", range(3))
def test_changelog_fuzz_matches_reference(seed):
    """One seeded sequence of scheduled-store writes, relists, assumes,
    queue arrivals and deltas through both packages' modelers: every
    delta names the same uids in the same order, every list the same
    set (the reference's stale queued copies dropped before each delta,
    as the port's modeler drops them: ``_drop_stale_copies``)."""
    rng = random.Random(500 + seed)
    models = [p.driver.SimpleModeler(p.cache.FIFO(), p.cache.Store())
              for p in (REF, PORT)]
    toks = [m.token() for m in models]
    names = [f"p{i}" for i in range(12)]
    for step in range(120):
        op = rng.random()
        name = rng.choice(names)
        gen = rng.randrange(3)
        host = rng.choice(["", "n1", "n2"])
        for pkg, m in zip((REF, PORT), models):
            pod = _pod(pkg, name, host=host, uid=f"uid-{name}-{gen}")
            if op < 0.35:
                m.scheduled.add(pod)
            elif op < 0.5:
                m.scheduled.delete(pod)
            elif op < 0.65:
                m.assume_pod(pod)
            elif op < 0.72:
                m.queued.add(pod)
            elif op < 0.78:
                keep = sorted(m.scheduled.list_keys())[::2]
                m.scheduled.replace([m.scheduled.get_by_key(k)
                                     for k in keep])
        if step % 7 == 6:
            _drop_stale_copies(models[0])
            outs = []
            for i, m in enumerate(models):
                d = m.delta(toks[i])
                ups, rms, toks[i] = d
                outs.append(([u.metadata.uid for u in ups],
                             [r.metadata.uid for r in rms],
                             sorted(p.metadata.uid for p in m.list())))
            assert outs[0] == outs[1], f"step {step}"
