"""The port's serial scheduler against the JAX package's.

- the port's predicates and priorities against the reference's on the
  fixtures of tests/test_scheduler.py, one parametrised case each: every
  predicate verdict and every (host, score) list must be equal;
- the port's ``GenericScheduler`` one pod at a time, committing each
  decision, on the waves of test_torch_batch_solver.py (named fixtures
  and seeded clusters) against the reference ``GenericScheduler`` and
  ``oracle.solve_serial``: the same host and the same priority list for
  every pod (tolerance 0: decisions and scores are integers);
- ``predicates_from_policy`` / ``priorities_from_policy`` on JSON
  Policies, the negative-weight Policy the scheduler binary falls back to
  serial for among them, through both packages' ``GenericScheduler``;
- the serial ``Scheduler.schedule_one`` loop of the port over its
  ``ConfigFactory`` and a FakeCluster.
"""

import copy

import pytest

from kubernetes_tpu.models.oracle import solve_serial
from kubernetes_tpu.scheduler import generic as ref_generic
from kubernetes_tpu.scheduler import listers as ref_listers
from kubernetes_tpu.scheduler import plugins as ref_plugins
from kubernetes_tpu.scheduler import predicates as ref_preds
from kubernetes_tpu.scheduler import priorities as ref_prios
from kubernetes_tpu_torch.runtime.clone import deep_clone
from kubernetes_tpu_torch.scheduler import driver as port_driver
from kubernetes_tpu_torch.scheduler import generic as port_generic
from kubernetes_tpu_torch.scheduler import listers as port_listers
from kubernetes_tpu_torch.scheduler import plugins as port_plugins
from kubernetes_tpu_torch.scheduler import predicates as port_preds
from kubernetes_tpu_torch.scheduler import priorities as port_prios
from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster
from test_torch_batch_solver import PORT, REF, WAVES


class Pkg:
    """One package's serial-scheduler modules next to its object Kit."""

    def __init__(self, kit, preds, prios, listers, plugins, generic):
        self.k, self.preds, self.prios = kit, preds, prios
        self.listers, self.plugins, self.generic = listers, plugins, generic

    def node_list(self, nodes):
        return self.k.api.NodeList(items=list(nodes))

    def args(self, nodes, pods, services=()):
        nl = self.node_list(nodes)
        return self.plugins.PluginFactoryArgs(
            pod_lister=self.listers.FakePodLister(list(pods)),
            service_lister=self.listers.FakeServiceLister(list(services)),
            node_lister=self.listers.FakeMinionLister(nl),
            node_info=self.listers.FakeNodeInfo(nl))


R = Pkg(REF, ref_preds, ref_prios, ref_listers, ref_plugins, ref_generic)
P = Pkg(PORT, port_preds, port_prios, port_listers, port_plugins,
        port_generic)


# -- predicates and priorities (the tests/test_scheduler.py fixtures) --------

def _svc(k):
    return k.svc("s", {"app": "web"})


def c_fits_resources(x):
    k = x.k
    node = k.node("n1", cpu_m=1000, mem=1 << 30)
    fit = x.preds.ResourceFit(x.listers.FakeNodeInfo(x.node_list([node])))
    existing = [k.pod("e1", cpu_m=500, mem=512 << 20, host="n1")]
    out = [fit.pod_fits_resources(p, existing, "n1") for p in (
        k.pod("a", cpu_m=400, mem=256 << 20), k.pod("b", cpu_m=600),
        k.pod("c", mem=600 << 20), k.pod("zero"))]
    node0 = k.node("n0")
    node0.spec.capacity = {}
    fit0 = x.preds.ResourceFit(x.listers.FakeNodeInfo(x.node_list([node0])))
    out.append(fit0.pod_fits_resources(
        k.pod("huge", cpu_m=100_000, mem=100 << 30), [], "n0"))
    return out


def c_fits_ports(x):
    k = x.k
    existing = [k.pod("e", host_ports=(8080,))]
    return [x.preds.pod_fits_ports(k.pod("a", host_ports=(8080,)), [], "n1"),
            x.preds.pod_fits_ports(k.pod("b", host_ports=(8080,)),
                                   existing, "n1"),
            x.preds.pod_fits_ports(k.pod("c", host_ports=(8081,)),
                                   existing, "n1"),
            x.preds.pod_fits_ports(k.pod("d", host_ports=(0,)),
                                   [k.pod("e0", host_ports=(0,))], "n1")]


def c_no_disk_conflict(x):
    k = x.k
    existing = [k.pod("e", pds=("disk-1",))]
    return [x.preds.no_disk_conflict(k.pod(n, pds=pds), existing, "n1")
            for n, pds in (("a", ("disk-1",)), ("b", ("disk-2",)),
                           ("c", ()))]


def c_node_selector(x):
    k = x.k
    node = k.node("n1", labels={"zone": "us-east", "disk": "ssd"})
    sel = x.preds.NodeSelector(x.listers.FakeNodeInfo(x.node_list([node])))
    return [sel.pod_selector_matches(k.pod(n, node_selector=s), [], "n1")
            for n, s in (("a", {"zone": "us-east"}), ("b", {"zone": "eu"}),
                         ("c", None))]


def c_fits_host(x):
    k = x.k
    return [x.preds.pod_fits_host(k.pod("a"), [], "n1"),
            x.preds.pod_fits_host(k.pod("b", host="n1"), [], "n1"),
            x.preds.pod_fits_host(k.pod("c", host="n1"), [], "n2")]


def c_label_presence(x):
    k = x.k
    node = k.node("n1", labels={"zone": "a", "retiring": "2015"})
    info = x.listers.FakeNodeInfo(x.node_list([node]))
    return [x.preds.NodeLabelChecker(info, labels, presence)
            .check_node_label_presence(k.pod("p"), [], "n1")
            for labels, presence in ((["zone"], True), (["retiring"], False),
                                     (["gpu"], True), (["gpu"], False))]


def c_service_affinity(x):
    k = x.k
    nodes = x.node_list([k.node("n1", labels={"zone": "z1"}),
                         k.node("n2", labels={"zone": "z2"})])
    info = x.listers.FakeNodeInfo(nodes)
    peer = k.pod("peer", labels={"app": "web"}, host="n1")
    out = []
    for peers in ([peer], []):
        aff = x.preds.ServiceAffinity(x.listers.FakePodLister(peers),
                                      x.listers.FakeServiceLister([_svc(k)]),
                                      info, ["zone"])
        out += [aff.check_service_affinity(
            k.pod("new", labels={"app": "web"}), [], n) for n in ("n1", "n2")]
    return out


def c_schedulable(x):
    k = x.k
    nodes = [k.node("a", unschedulable=True), k.node("b")]
    s = x.preds.Schedulable(x.listers.FakeNodeInfo(x.node_list(nodes)))
    return [s.pod_is_schedulable(k.pod("p"), [], n) for n in ("a", "b")]


def _scores(hps):
    return [(hp.host, hp.score) for hp in hps]


def c_calculate_score(x):
    return [x.prios.calculate_score(r, c, "n")
            for r, c in ((0, 0), (11, 10), (0, 10), (5, 10), (1, 3))]


def c_least_requested(x):
    k = x.k
    nodes = x.node_list([k.node("busy", cpu_m=1000, mem=1 << 30),
                         k.node("idle", cpu_m=1000, mem=1 << 30)])
    existing = [k.pod("e", cpu_m=500, mem=512 << 20, host="busy")]
    return _scores(x.prios.least_requested_priority(
        k.pod("x", cpu_m=100, mem=128 << 20),
        x.listers.FakePodLister(existing), x.listers.FakeMinionLister(nodes)))


def c_service_spread(x):
    k = x.k
    nodes = x.node_list([k.node(f"n{i}") for i in (1, 2, 3)])
    peers = [k.pod("a", labels={"app": "web"}, host="n1"),
             k.pod("b", labels={"app": "web"}, host="n1"),
             k.pod("c", labels={"app": "web"}, host="n2")]
    return _scores(x.prios.ServiceSpread(
        x.listers.FakeServiceLister([_svc(k)])).calculate_spread_priority(
        k.pod("new", labels={"app": "web"}), x.listers.FakePodLister(peers),
        x.listers.FakeMinionLister(nodes)))


def c_anti_affinity(x):
    k = x.k
    nodes = x.node_list([k.node("n1", labels={"zone": "z1"}),
                         k.node("n2", labels={"zone": "z2"}),
                         k.node("n3")])
    peers = [k.pod("a", labels={"app": "web"}, host="n1")]
    return _scores(x.prios.ServiceAntiAffinity(
        x.listers.FakeServiceLister([_svc(k)]), "zone")
        .calculate_anti_affinity_priority(
        k.pod("new", labels={"app": "web"}), x.listers.FakePodLister(peers),
        x.listers.FakeMinionLister(nodes)))


def c_equal_and_label_priority(x):
    k = x.k
    nodes = x.node_list([k.node("n1", labels={"gpu": "yes"}), k.node("n2")])
    pods, minions = x.listers.FakePodLister([]), \
        x.listers.FakeMinionLister(nodes)
    return (_scores(x.prios.equal_priority(k.pod("x"), pods, minions))
            + _scores(x.prios.NodeLabelPrioritizer("gpu", True)
                      .calculate_node_label_priority(k.pod("x"), pods,
                                                     minions))
            + _scores(x.prios.NodeLabelPrioritizer("gpu", False)
                      .calculate_node_label_priority(k.pod("x"), pods,
                                                     minions)))


def c_spread_score_f32(x):
    return [x.prios.spread_score_f32(t, c)
            for t in (1, 3, 7, 10, 33, 1000) for c in range(0, t + 1, 3)]


def c_fit_error_message(x):
    k = x.k
    nodes = x.node_list([k.node("n1", cpu_m=1000, mem=1 << 30)])
    keys = x.plugins.get_algorithm_provider(x.plugins.DEFAULT_PROVIDER)
    a = x.args(nodes.items, [])
    s = x.generic.GenericScheduler(
        x.plugins.get_predicates(keys["predicates"], a),
        x.plugins.get_priorities(keys["priorities"], a), a.pod_lister)
    with pytest.raises(x.generic.FitError) as ei:
        s.schedule(k.pod("x", cpu_m=10_000), x.listers.FakeMinionLister(nodes))
    return str(ei.value)


CASES = {f.__name__[2:]: f for f in (
    c_fits_resources, c_fits_ports, c_no_disk_conflict, c_node_selector,
    c_fits_host, c_label_presence, c_service_affinity, c_schedulable,
    c_calculate_score, c_least_requested, c_service_spread, c_anti_affinity,
    c_equal_and_label_priority, c_spread_score_f32, c_fit_error_message)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_predicates_and_priorities_match_the_reference(name):
    assert CASES[name](P) == CASES[name](R)


# -- GenericScheduler one pod at a time --------------------------------------

def _walk(x, nodes, existing, pending, services, policy_json=None):
    """Each pending pod through x's GenericScheduler, committing every
    decision before the next -> [(host or None, [(host, score), ...])]."""
    committed = list(existing)
    args = x.args(nodes, committed, services)
    args.pod_lister.pods = committed        # commits become visible
    if policy_json is not None:
        policy = x.plugins.load_policy(policy_json)
        preds = x.plugins.predicates_from_policy(policy, args)
        prios = x.plugins.priorities_from_policy(policy, args)
    else:
        keys = x.plugins.get_algorithm_provider(x.plugins.DEFAULT_PROVIDER)
        preds = x.plugins.get_predicates(keys["predicates"], args)
        prios = x.plugins.get_priorities(keys["priorities"], args)
    sched = x.generic.GenericScheduler(preds, prios, args.pod_lister)
    minions = args.node_lister
    out = []
    for pod in pending:
        filtered, _failed = sched.find_nodes_that_fit(pod, minions.list())
        plist = _scores(sched.prioritize_nodes(
            pod, x.listers.FakeMinionLister(filtered)))
        try:
            host = sched.schedule(pod, minions)
        except x.generic.FitError:
            host = None
        if host is not None:
            bound = copy.deepcopy(pod)
            bound.spec.host = host
            bound.status.host = host
            committed.append(bound)
        out.append((host, plist))
    return out


SERIAL_WAVES = sorted(n for n in WAVES if not n.startswith("fuzz_")) + \
    [f"fuzz_{s}" for s in range(6)] + ["fuzz_rdim_0", "fuzz_rdim_1"]


@pytest.mark.parametrize("name", SERIAL_WAVES)
def test_generic_scheduler_matches_reference_and_oracle(name):
    port_wave, ref_wave = WAVES[name](PORT), WAVES[name](REF)
    got = _walk(P, *port_wave)
    want = _walk(R, *ref_wave)
    assert got == want
    assert [h for h, _ in got] == solve_serial(*ref_wave)


# -- Policies ----------------------------------------------------------------

POLICIES = {
    "round_trip": """
    {"kind": "Policy", "apiVersion": "v1",
     "predicates": [
        {"name": "PodFitsPorts"}, {"name": "PodFitsResources"},
        {"name": "ZoneAffinity",
         "argument": {"serviceAffinity": {"labels": ["zone"]}}},
        {"name": "RequireRegion", "argument": {"labelsPresence":
            {"labels": ["region"], "presence": true}}}],
     "priorities": [
        {"name": "LeastRequestedPriority", "weight": 2},
        {"name": "ZoneSpread", "weight": 1,
         "argument": {"serviceAntiAffinity": {"label": "zone"}}},
        {"name": "PreferGPU", "weight": 3,
         "argument": {"labelPreference": {"label": "gpu",
                                          "presence": true}}}]}""",
    # the binary's serial fallback: a negative weight packs nodes full
    "negative_weight": """
    {"predicates": [{"name": "PodFitsPorts"}, {"name": "PodFitsResources"},
                    {"name": "MatchNodeSelector"}, {"name": "HostName"}],
     "priorities": [{"name": "LeastRequestedPriority", "weight": -1},
                    {"name": "ServiceSpreadingPriority", "weight": 2}]}""",
    "no_priorities": """
    {"predicates": [{"name": "PodFitsResources"}], "priorities": []}""",
    "avoid_label": """
    {"predicates": [{"name": "PodFitsResources"},
                    {"name": "NoRetiring", "argument": {"labelsPresence":
                        {"labels": ["retiring"], "presence": false}}}],
     "priorities": [{"name": "EqualPriority", "weight": 1},
                    {"name": "AvoidGPU", "weight": 2, "argument":
                        {"labelPreference": {"label": "gpu",
                                             "presence": false}}}]}""",
}


def _policy_wave(k):
    nodes = [k.node(f"n{i}", cpu_m=2000 + 1000 * (i % 3),
                    labels={"zone": f"z{i % 3}", "region": "r",
                            **({"gpu": "y"} if i % 4 == 0 else {}),
                            **({"retiring": "y"} if i == 5 else {})})
             for i in range(8)]
    nodes.append(k.node("unlabeled"))
    existing = [k.pod(f"e{i}", cpu_m=300, host=f"n{i % 4}",
                      labels={"app": "web" if i % 2 else "db"})
                for i in range(6)]
    pending = [k.pod(f"p{i:02d}", cpu_m=200 + 100 * (i % 5),
                     mem=(64 << 20) * (1 + i % 3),
                     labels={"app": ("web", "db", "cache")[i % 3]},
                     host_ports=(8080,) if i % 7 == 0 else ())
               for i in range(24)]
    return nodes, existing, pending, [k.svc("web", {"app": "web"}),
                                      k.svc("db", {"app": "db"})]


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policies_build_the_same_scheduler(name):
    text = POLICIES[name]
    got = _walk(P, *_policy_wave(PORT), policy_json=text)
    want = _walk(R, *_policy_wave(REF), policy_json=text)
    assert got == want
    ref_wave = _policy_wave(REF)
    assert [h for h, _ in got] == solve_serial(
        *ref_wave, policy=ref_plugins.load_policy(text))
    # the plugin maps themselves: the same names in the same order
    pa, ra = P.args(*_policy_wave(PORT)[:2]), R.args(*ref_wave[:2])
    pp, rp = port_plugins.load_policy(text), ref_plugins.load_policy(text)
    assert list(port_plugins.predicates_from_policy(pp, pa)) == \
        list(ref_plugins.predicates_from_policy(rp, ra))
    assert [c.weight for c in port_plugins.priorities_from_policy(pp, pa)] \
        == [c.weight for c in ref_plugins.priorities_from_policy(rp, ra)]


def test_negative_weight_policy_is_unsupported_by_the_batch_solver():
    from kubernetes_tpu_torch.models.policy import (UnsupportedPolicy,
                                                    batch_policy_from)
    with pytest.raises(UnsupportedPolicy, match="negative"):
        batch_policy_from(None, port_plugins.load_policy(
            POLICIES["negative_weight"]))


# -- the serial loop ----------------------------------------------------------

def test_serial_scheduler_loop_binds_like_the_oracle():
    """The port's Scheduler.schedule_one over its ConfigFactory (provider
    algorithm) and a FakeCluster binds each pending pod where the oracle
    puts it, in FIFO order."""
    port_wave, ref_wave = WAVES["spreading"](PORT), WAVES["spreading"](REF)
    nodes, existing, pending, services = port_wave
    cluster = FakeCluster(nodes, existing, [deep_clone(p) for p in pending],
                          services)
    factory = port_driver.ConfigFactory(cluster.client,
                                        node_poll_period=3600)
    cluster.attach(factory)
    sched = port_driver.Scheduler(factory.create())
    try:
        cluster.wait_synced()
        got = {}
        for _ in pending:
            pod_host = sched.schedule_one(timeout=2.0)
            assert pod_host is not None
        got = {p.metadata.name: p.spec.host for p in cluster.bind_log}
        want = dict(zip((p.metadata.name for p in pending),
                        solve_serial(*ref_wave)))
        assert got == want
    finally:
        assert factory.stop(join=True)
