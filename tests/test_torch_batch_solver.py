"""The PyTorch port's whole wave, on the CPU, against the JAX package.

One wave built twice from the same seed — through the JAX package's API
types and through the port's — goes through each package's
encode_snapshot and solve; the port's decisions and winning scores must be
bit-identical to the JAX ``batch_solver.solve`` and its names to the
serial oracle ``oracle.solve_serial`` (tolerance 0: decisions are
integers). The wave builders here are shared with test_torch_encode.py.
"""

import dataclasses
import random

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

import bench
from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.api.quantity import Quantity as RefQuantity
from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.oracle import solve_serial
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.api.quantity import Quantity as PortQuantity
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import fixtures
from kubernetes_tpu_torch.models.policy import BatchPolicy, batch_policy_from
from kubernetes_tpu_torch.models.snapshot import encode_snapshot

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)


class Kit:
    """Object builders over one package's API types."""

    def __init__(self, api, quantity, build_cluster):
        self.api, self.Q, self.build_cluster = api, quantity, build_cluster

    def node(self, name, cpu_m=4000, mem=8 << 30, labels=None, extra=None,
             unschedulable=False):
        cap = {"cpu": self.Q(f"{cpu_m}m"), "memory": self.Q(mem)}
        for k, v in (extra or {}).items():
            cap[k] = self.Q(v)
        return self.api.Node(
            metadata=self.api.ObjectMeta(name=name, labels=labels or {}),
            spec=self.api.NodeSpec(capacity=cap,
                                   unschedulable=unschedulable))

    def pod(self, name, ns="default", cpu_m=0, mem=0, host="", labels=None,
            node_selector=None, host_ports=(), pds=(), extra=None,
            priority=None, annotations=None):
        api = self.api
        limits = {}
        if cpu_m:
            limits["cpu"] = self.Q(f"{cpu_m}m")
        if mem:
            limits["memory"] = self.Q(mem)
        for k, v in (extra or {}).items():
            limits[k] = self.Q(v)
        return api.Pod(
            metadata=api.ObjectMeta(name=name, namespace=ns,
                                    uid=f"uid-{ns}-{name}",
                                    labels=labels or {},
                                    annotations=annotations or {}),
            spec=api.PodSpec(
                host=host, node_selector=node_selector or {},
                priority=priority,
                containers=[api.Container(
                    name="c", image="i",
                    ports=[api.ContainerPort(container_port=80 + i,
                                             host_port=p)
                           for i, p in enumerate(host_ports)],
                    resources=api.ResourceRequirements(limits=limits))],
                volumes=[api.Volume(name=f"v{i}", source=api.VolumeSource(
                    gce_persistent_disk=api.GCEPersistentDiskVolumeSource(
                        pd_name=pd)))
                    for i, pd in enumerate(pds)]),
            status=api.PodStatus(host=host))

    def svc(self, name, selector, ns="default"):
        return self.api.Service(
            metadata=self.api.ObjectMeta(name=name, namespace=ns),
            spec=self.api.ServiceSpec(port=80, selector=selector))


REF = Kit(ref_api, RefQuantity, bench.build_cluster)
PORT = Kit(port_api, PortQuantity, fixtures.build_cluster)


# -- waves (each a function of a Kit) ----------------------------------------

def w_empty_pending(k):
    return [k.node("n1")], [], [], []


def w_least_requested(k):
    return ([k.node("busy"), k.node("idle")],
            [k.pod("e", cpu_m=3000, mem=6 << 30, host="busy")],
            [k.pod("x", cpu_m=500, mem=1 << 30)], [])


def w_sequential_commits(k):
    nodes = [k.node("a", cpu_m=1000, mem=1 << 30),
             k.node("b", cpu_m=1000, mem=1 << 30)]
    return nodes, [], [k.pod(f"p{i}", cpu_m=600, mem=100 << 20)
                       for i in range(3)], []


def w_capacity_exhaustion(k):
    return ([k.node("n", cpu_m=1000, mem=1 << 30)], [],
            [k.pod("big", cpu_m=2000), k.pod("ok", cpu_m=500),
             k.pod("overflow", cpu_m=600)], [])


def w_zero_request(k):
    return ([k.node("full", cpu_m=100, mem=1 << 20)],
            [k.pod("hog", cpu_m=100, mem=1 << 20, host="full")],
            [k.pod("zero")], [])


def w_zero_capacity(k):
    n = k.api.Node(metadata=k.api.ObjectMeta(name="limitless"),
                   spec=k.api.NodeSpec(capacity={}))
    return [n], [], [k.pod("huge", cpu_m=10**6, mem=1 << 40)], []


def w_host_ports(k):
    return ([k.node("a"), k.node("b")], [],
            [k.pod(f"p{i}", host_ports=(8080,)) for i in range(3)], [])


def w_selector_and_host(k):
    return ([k.node("gpu", labels={"accel": "tpu"}), k.node("plain")], [],
            [k.pod("wants-accel", node_selector={"accel": "tpu"}),
             k.pod("pinned", host="plain"),
             k.pod("pinned-unknown", host="ghost")], [])


def w_pd_conflicts(k):
    return ([k.node("a"), k.node("b")],
            [k.pod("e", host="a", pds=("disk-1",))],
            [k.pod("p1", pds=("disk-1",)), k.pod("p2", pds=("disk-1",))], [])


def w_spreading(k):
    return ([k.node(f"n{i}") for i in range(4)], [],
            [k.pod(f"w{i}", labels={"app": "web"}) for i in range(8)],
            [k.svc("web", {"app": "web"})])


def w_unassigned_peers(k):
    return ([k.node("n0"), k.node("n1")],
            [k.pod("floating", labels={"app": "x"}, host="")],
            [k.pod("p", labels={"app": "x"})], [k.svc("s", {"app": "x"})])


def w_tie_break(k):
    return [k.node(f"n{i}") for i in range(7)], [], \
        [k.pod(f"p{i}") for i in range(7)], []


def w_namespaces(k):
    return ([k.node(f"n{i}") for i in range(3)], [],
            [k.pod("a1", ns="ns1", labels={"app": "a"}),
             k.pod("b1", ns="ns2", labels={"app": "b"}),
             k.pod("a2", ns="ns1", labels={"app": "a"}),
             k.pod("c", ns="ns1")],
            [k.svc("a", {"app": "a"}, ns="ns1"),
             k.svc("b", {"app": "b"}, ns="ns2")])


def w_cordoned(k):
    return ([k.node("a", unschedulable=True), k.node("b")], [],
            [k.pod(f"p{i}", cpu_m=100) for i in range(3)], [])


def w_third_dimension(k):
    nodes = [k.node("gpu0", extra={"nvidia.com/gpu": 2}),
             k.node("gpu1", extra={"nvidia.com/gpu": 1}), k.node("plain")]
    return nodes, [], [k.pod(f"g{i}", cpu_m=100, mem=64 << 20,
                             extra={"nvidia.com/gpu": 1})
                       for i in range(4)], []


def w_extra_dimension_average(k):
    nodes = [k.node("a", cpu_m=1000, mem=1 << 30,
                    extra={"ephemeral-storage": 100 << 30}),
             k.node("b", cpu_m=1000, mem=1 << 30)]
    existing = [k.pod("e0", cpu_m=500, mem=512 << 20, host="a"),
                k.pod("e1", cpu_m=100, mem=64 << 20, host="b")]
    return nodes, existing, [
        k.pod(f"p{i}", cpu_m=100, mem=64 << 20,
              extra={"ephemeral-storage": 10 << 30} if i % 2 else None)
        for i in range(6)], []


def w_request_only(k):
    return ([k.node("n0"), k.node("n1")], [],
            [k.pod("p0", extra={"fpga": 4}),
             k.pod("p1", cpu_m=100, extra={"fpga": 1}), k.pod("p2")], [])


def w_zero_quantity_advertisement(k):
    nodes = [k.node("drained", extra={"nvidia.com/gpu": 0}),
             k.node("a"), k.node("b", cpu_m=2000)]
    return nodes, [k.pod("e0", cpu_m=1000, mem=2 << 30, host="a")], \
        [k.pod(f"p{i}", cpu_m=500, mem=512 << 20) for i in range(4)], []


def w_divisor_follows_filter(k):
    nodes = [k.node("gpu", extra={"nvidia.com/gpu": 2}),
             k.node("a"), k.node("b", cpu_m=2000)]
    return nodes, [k.pod("holder", host="gpu", host_ports=(8080,))], \
        [k.pod(f"p{i}", cpu_m=500, mem=512 << 20, host_ports=(8080,))
         for i in range(3)], []


def w_overcommitted_node(k):
    # existing pods overflow n0, so it is pre-exceeded (fit_exceeded)
    nodes = [k.node("n0", cpu_m=1000), k.node("n1", cpu_m=1000)]
    existing = [k.pod(f"e{i}", cpu_m=600, host="n0") for i in range(3)]
    return nodes, existing, [k.pod("p", cpu_m=100), k.pod("z")], []


def w_fuzz(k, seed):
    """test_batch_solver.test_fuzz_equivalence's generator."""
    rng = random.Random(seed)
    n_nodes = rng.randint(1, 16)
    n_existing = rng.randint(0, 20)
    n_pending = rng.randint(1, 40)
    zones = ["z1", "z2", "z3"]
    nodes = []
    for i in range(n_nodes):
        labels = {}
        if rng.random() < 0.5:
            labels["zone"] = rng.choice(zones)
        if rng.random() < 0.3:
            labels["disk"] = "ssd"
        nodes.append(k.node(
            f"n{i}", cpu_m=rng.choice([500, 1000, 2000, 4000]),
            mem=rng.choice([1 << 30, 2 << 30, 8 << 30]), labels=labels))
    services = [k.svc("svc-a", {"app": "a"}), k.svc("svc-b", {"app": "b"})]

    def random_pod(name, may_have_host):
        kw = dict(
            cpu_m=rng.choice([0, 100, 250, 500, 1000]),
            mem=rng.choice([0, 64 << 20, 512 << 20, 1 << 30]),
            labels=({"app": rng.choice(["a", "b", "c"])}
                    if rng.random() < 0.7 else {}))
        if rng.random() < 0.3:
            kw["host_ports"] = (rng.choice([8080, 9090]),)
        if rng.random() < 0.2:
            kw["node_selector"] = {"zone": rng.choice(zones)}
        if rng.random() < 0.15:
            kw["pds"] = (rng.choice(["pd1", "pd2"]),)
        if may_have_host:
            kw["host"] = rng.choice([n.metadata.name for n in nodes]
                                    + ["", "dead-node"])
        return k.pod(name, **kw)

    existing = [random_pod(f"e{i}", True) for i in range(n_existing)]
    pending = [random_pod(f"p{i}", False) for i in range(n_pending)]
    return nodes, existing, pending, services


def w_fuzz_rdim(k, seed):
    """test_batch_solver.test_fuzz_equivalence_r_dimensional's generator."""
    rng = random.Random(1000 + seed)
    nodes = []
    for i in range(rng.randint(2, 10)):
        extra = {}
        if rng.random() < 0.6:
            extra["nvidia.com/gpu"] = rng.choice([1, 2, 4])
        if rng.random() < 0.4:
            extra["ephemeral-storage"] = rng.choice([50 << 30, 200 << 30])
        nodes.append(k.node(f"n{i}", cpu_m=rng.choice([1000, 2000, 4000]),
                            mem=rng.choice([2 << 30, 8 << 30]), extra=extra))

    def rpod(name, may_have_host):
        extra = {}
        if rng.random() < 0.4:
            extra["nvidia.com/gpu"] = rng.choice([1, 2])
        if rng.random() < 0.3:
            extra["ephemeral-storage"] = rng.choice([10 << 30, 40 << 30])
        kw = dict(cpu_m=rng.choice([0, 100, 500]),
                  mem=rng.choice([0, 64 << 20, 1 << 30]), extra=extra)
        if may_have_host:
            kw["host"] = rng.choice([n.metadata.name for n in nodes] + [""])
        return k.pod(name, **kw)

    existing = [rpod(f"e{i}", True) for i in range(rng.randint(0, 15))]
    pending = [rpod(f"p{i}", False) for i in range(rng.randint(1, 30))]
    return nodes, existing, pending, []


WAVES = {f.__name__[2:]: f for f in (
    w_empty_pending, w_least_requested, w_sequential_commits,
    w_capacity_exhaustion, w_zero_request, w_zero_capacity, w_host_ports,
    w_selector_and_host, w_pd_conflicts, w_spreading, w_unassigned_peers,
    w_tie_break, w_namespaces, w_cordoned, w_third_dimension,
    w_extra_dimension_average, w_request_only,
    w_zero_quantity_advertisement, w_divisor_follows_filter,
    w_overcommitted_node)}
for _s in range(12):
    WAVES[f"fuzz_{_s}"] = lambda k, s=_s: w_fuzz(k, s)
for _s in range(6):
    WAVES[f"fuzz_rdim_{_s}"] = lambda k, s=_s: w_fuzz_rdim(k, s)
WAVES["bench_60x100"] = lambda k: k.build_cluster(60, 100)
WAVES["bench_binpack3_60x100"] = lambda k: k.build_cluster(
    60, 100, three_resources=True)


def _solve_both(name):
    ref_wave, port_wave = WAVES[name](REF), WAVES[name](PORT)
    jsnap = ref_encode(*ref_wave)
    psnap = encode_snapshot(*port_wave)
    jc, js = ref_bs.solve(jsnap)
    pc, ps = bs.solve(psnap, device="cpu")
    return ref_wave, jsnap, psnap, (np.asarray(jc), np.asarray(js)), (pc, ps)


@pytest.mark.parametrize("name", list(WAVES))
def test_slice_matches_solve_and_oracle(name):
    ref_wave, jsnap, psnap, (jc, js), (pc, ps) = _solve_both(name)
    assert pc.dtype == np.int32 and ps.dtype == np.int32
    assert np.array_equal(pc, jc), f"chosen: port {pc} vs jax {jc}"
    assert np.array_equal(ps, js), f"scores: port {ps} vs jax {js}"
    names = bs.decisions_to_names(psnap, pc)
    assert names == ref_bs.decisions_to_names(jsnap, jc)
    assert names == solve_serial(*ref_wave)


def test_basic_shape_matches_solve_and_oracle():
    # the benchmark's `basic` shape, 500 nodes x 1,000 pods
    n_nodes, n_pods, kw, _policy = fixtures.FULL_SHAPES["basic"]
    ref_wave = bench.build_cluster(n_nodes, n_pods, **kw)
    jsnap = ref_encode(*ref_wave)
    psnap = encode_snapshot(*fixtures.build_cluster(n_nodes, n_pods, **kw))
    jc, js = ref_bs.solve(jsnap)
    pc, ps = bs.solve(psnap, device="cpu")
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))
    names = bs.decisions_to_names(psnap, pc)
    assert None not in names
    assert names == solve_serial(*ref_wave)


def test_no_nodes_leaves_every_pod_unscheduled():
    # the JAX scan cannot take a zero-node wave; the oracle can
    ref_wave = ([], [], [REF.pod("p", cpu_m=100)], [])
    psnap = encode_snapshot([], [], [PORT.pod("p", cpu_m=100)], [])
    pc, ps = bs.solve(psnap, device="cpu")
    assert bs.decisions_to_names(psnap, pc) == solve_serial(*ref_wave)
    assert ps.tolist() == [-1]


def test_custom_weights_match_reference_scan():
    pol = BatchPolicy(w_lr=2, w_spread=3, w_equal=1)
    from kubernetes_tpu.models.policy import BatchPolicy as RefPolicy
    jsnap = ref_encode(*w_fuzz(REF, 99), policy=RefPolicy(
        w_lr=2, w_spread=3, w_equal=1))
    psnap = encode_snapshot(*w_fuzz(PORT, 99), policy=pol)
    jc, js = ref_bs.solve(jsnap)
    pc, ps = bs.solve(psnap, device="cpu")
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))


def test_all_infeasible_policy_places_nothing():
    pol = BatchPolicy(w_lr=0, w_spread=0, all_infeasible=True)
    psnap = encode_snapshot(*w_fuzz(PORT, 3), policy=pol)
    pc, ps = bs.solve(psnap, device="cpu")
    assert (pc == -1).all() and (ps == -1).all()


def test_wide_wave_takes_the_scan_and_matches():
    # 40 services pad the group axis to 64 > the kernel's 31: the wave
    # leaves the kernel's domain and solve_device takes solve_scan
    def wave(k):
        nodes = [k.node(f"n{i}") for i in range(6)]
        svcs = [k.svc(f"s{j}", {"app": f"a{j}"}) for j in range(40)]
        pods = [k.pod(f"p{i}", cpu_m=100, labels={"app": f"a{i % 40}"})
                for i in range(50)]
        return nodes, [], pods, svcs

    psnap = encode_snapshot(*wave(PORT))
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(psnap), "cpu")
    from kubernetes_tpu_torch.ops import commit_solver
    assert not commit_solver.eligible(inp, psnap.policy,
                                      bs.peer_bound_of(psnap))
    jc, js = ref_bs.solve(ref_encode(*wave(REF)))
    pc, ps = bs.solve(psnap, device="cpu")
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))


# -- the device default, the policy and gang branches, what is refused -------

def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    psnap = encode_snapshot(*w_least_requested(PORT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bs.solve(psnap)


def _gang_wave(k):
    from kubernetes_tpu.models import gang as ref_gang
    ann = {ref_gang.GANG_NAME_ANNOTATION: "g"}
    # the second gang cannot fit whole: it is rolled back, and the
    # singleton after it takes the room its first members held
    return ([k.node("n0", cpu_m=1000), k.node("n1", cpu_m=1000)], [],
            [k.pod(f"a{i}", cpu_m=400, annotations=ann) for i in range(2)]
            + [k.pod(f"b{i}", cpu_m=500, annotations={
                ref_gang.GANG_NAME_ANNOTATION: "h"}) for i in range(3)]
            + [k.pod("solo", cpu_m=600)], [])


def test_gang_wave_matches_reference():
    # a gang wave solves, all or nothing, as the reference and the oracle
    psnap = encode_snapshot(*_gang_wave(PORT))
    assert psnap.has_gangs
    pc, ps = bs.solve(psnap, device="cpu")
    jc, js = ref_bs.solve(ref_encode(*_gang_wave(REF)))
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))
    names = bs.decisions_to_names(psnap, pc)
    assert names == solve_serial(*_gang_wave(REF), gangs=True)
    assert names[2:5] == [None, None, None] and names[5] is not None


def test_preemption_wave_is_refused():
    # once refused, the preemption wave is now solved: the decision and
    # its preemption score equal the JAX package's, the victims its
    # serial preemption oracle's
    from kubernetes_tpu.models import preempt as ref_preempt
    from kubernetes_tpu.models.oracle import preempt_serial
    from kubernetes_tpu_torch.models import preempt

    def wave(k):
        return ([k.node("n0", cpu_m=1000)],
                [k.pod("low", cpu_m=1000, host="n0", priority=0)],
                [k.pod("high", cpu_m=1000, priority=100)])

    psnap = encode_snapshot(*wave(PORT))
    jsnap = ref_encode(*wave(REF))
    assert psnap.band_prio.size
    pc, ps = bs.solve(psnap, device="cpu")
    jc, js = ref_bs.solve(jsnap)
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))
    assert preempt.is_preempt_score(int(ps[0]))
    nodes, existing, pending = wave(PORT)
    victims = preempt.assign_victims(
        pc, ps, psnap.band_prio,
        preempt.resident_from_pods(existing, {"n0": 0}), n_pods=1)
    names, s_victims = preempt_serial(*wave(REF))
    assert bs.decisions_to_names(psnap, pc) == names == ["n0"]
    assert [[v.uid for v in victims[0]]] == \
        [[v.uid for v in s_victims[0]]] == [["uid-default-low"]]
    assert ref_preempt.PREEMPT_SCORE_BASE == preempt.PREEMPT_SCORE_BASE


def test_policy_extensions_match_reference():
    # a wave under every policy extension solves as the reference does
    from kubernetes_tpu.models.policy import BatchPolicy as RefPolicy
    kw = dict(anti_affinity=(("zone", 2),), label_prefs=(("disk", True, 1),),
              affinity_labels=("zone",),
              label_presence=((("zone",), True),))
    psnap = encode_snapshot(*w_fuzz(PORT, 7), policy=BatchPolicy(**kw))
    jsnap = ref_encode(*w_fuzz(REF, 7), policy=RefPolicy(**kw))
    pc, ps = bs.solve(psnap, device="cpu")
    jc, js = ref_bs.solve(jsnap)
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))


def test_int64_resource_planes_are_refused():
    # once refused, a 3-byte-granular memory capacity that cannot be
    # scaled under 2^31/10 now solves on int64 planes, as the reference's
    def wave(k):
        nodes = [k.node("n0", mem=(1 << 40) + 3), k.node("n1", mem=8 << 30)]
        return nodes, [], [k.pod(f"p{i}", cpu_m=500, mem=1 + i * (1 << 30))
                           for i in range(6)], []

    psnap = encode_snapshot(*wave(PORT))
    assert bs.snapshot_to_host_inputs(psnap).cap.dtype == np.int64
    pc, ps = bs.solve(psnap, device="cpu")
    jc, js = ref_bs.solve(ref_encode(*wave(REF)))
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))
    assert bs.decisions_to_names(psnap, pc) == solve_serial(*wave(REF))


def test_batch_policy_from_default_provider():
    from kubernetes_tpu.models.policy import batch_policy_from as ref_from
    from kubernetes_tpu.scheduler.plugins import Policy as RefPolicyFile
    from kubernetes_tpu_torch.scheduler.plugins import Policy
    assert batch_policy_from() == BatchPolicy()
    # the Policy branch: an empty Policy enables nothing and falls back to
    # raw EqualPriority scores
    bp = batch_policy_from(policy=Policy())
    assert bp == BatchPolicy(use_ports=False, use_resources=False,
                             use_disk=False, use_selector=False,
                             use_host=False, w_lr=0, w_spread=0, w_equal=1)
    assert dataclasses.asdict(bp) == dataclasses.asdict(
        ref_from(policy=RefPolicyFile()))
