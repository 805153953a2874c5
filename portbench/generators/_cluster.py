"""What every burst generator shares: the pod mix drawn from the seed, the
base cluster, and the API objects the program is handed.

Each mix is drawn as a fixed set of values in a seeded order: a wave of P
pods holds every value of a range in the same numbers whatever the seed,
so seeds change which pod asks what and which tie-break keys they carry,
not the amount of work. Every number the reference reads comes from the
same draw as the object the program reads.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.models import gang as gang_mod
from portbench.reference.scheduler import Cluster, Wave

__all__ = ["Base", "Burst", "base_cluster", "draw_mix", "make_pods",
           "rng_for"]

_MI = 1 << 20


class Base(NamedTuple):
    """The cluster every wave of a run is scheduled against."""

    nodes: list
    residents: list
    services: list
    namespace: str
    plain: Cluster
    node_index: Dict[str, int]


class Burst(NamedTuple):
    """One wave: the pod objects handed to the program and the plain
    description of the same pods handed to the reference."""

    pods: list
    plain: Wave


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run (the base cluster, one wave)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def _steps(spec) -> np.ndarray:
    lo, hi, step = spec
    return np.arange(lo, hi + 1, step, dtype=np.int64)


def draw_mix(mix: dict, n: int, n_services: int,
             rng: np.random.Generator) -> dict:
    """The per-pod mix of ``n`` pods: cpu (milli) and memory (bytes) cycled
    over their ranges, an exact share of host ports cycled over theirs,
    services cycled (-1, no service label, where there are none), an
    exact share of memory written in decimal units; each column in its
    own seeded order."""

    def cycled(values: np.ndarray) -> np.ndarray:
        return rng.permutation(np.resize(values, n))

    def share(k: int, values: np.ndarray) -> np.ndarray:
        out = np.zeros(n, np.int64)
        out[:k] = np.resize(values, k)
        return rng.permutation(out)

    cpu = cycled(_steps(mix["cpu_m"]))
    mem_mi = cycled(_steps(mix["memory_mi"]))
    k_ports = round(n * mix.get("host_port_share", 0))
    port = (share(k_ports, np.arange(mix["host_ports"][0],
                                     mix["host_ports"][1] + 1,
                                     dtype=np.int64))
            if k_ports else np.zeros(n, np.int64))
    service = (cycled(np.arange(n_services, dtype=np.int64)) if n_services
               else np.full(n, -1, np.int64))
    dec = mix.get("decimal_memory")
    mem_dec_mb = (share(round(n * dec["share"]), _steps(dec["mb"]))
                  if dec else np.zeros(n, np.int64))
    mem = np.where(mem_dec_mb > 0, mem_dec_mb * 10**6, mem_mi * _MI)
    return {"cpu": cpu, "mem": mem, "mem_mi": mem_mi,
            "mem_dec_mb": mem_dec_mb, "port": port, "service": service}


@functools.lru_cache(maxsize=None)
def _parsed(text: str) -> Quantity:
    return Quantity(text)


def _quantity(text: str) -> Quantity:
    """A new Quantity of ``text``, as a decoder makes one: its own object,
    nothing memoized on it (the parse itself is shared)."""
    return Quantity(_parsed(text))


def _pod(name: str, uid: str, namespace: str, app: Optional[str],
         cpu_m: int, mem_text: str, port: int, host: str = "",
         annotations: Optional[dict] = None) -> api.Pod:
    """One pod as scheduler_perf's pod template has it: one container
    with container port 80 and cpu and memory limits; ``port`` (0: none)
    is its host port, ``app`` (None: none) its service label."""
    return api.Pod(
        metadata=api.ObjectMeta(
            name=name, namespace=namespace, uid=uid,
            labels={"app": app} if app else {},
            annotations=dict(annotations or {})),
        spec=api.PodSpec(
            host=host,
            containers=[api.Container(
                name="c", image="img",
                ports=[api.ContainerPort(container_port=80, host_port=port)],
                resources=api.ResourceRequirements(limits={
                    "cpu": _quantity(f"{cpu_m}m"),
                    "memory": _quantity(mem_text)}))]),
        status=api.PodStatus(host=host))


def _mem_text(mix: dict, i: int) -> str:
    dec = int(mix["mem_dec_mb"][i])
    return f"{dec}M" if dec else f"{int(mix['mem_mi'][i])}Mi"


def _app(service: int) -> Optional[str]:
    return f"app-{service}" if service >= 0 else None


def _labels(config: dict, i: int) -> dict:
    """Node ``i``'s labels: a zone of ``zones`` and a disk of ``hdd_every``
    where the configuration gives them, none otherwise."""
    out = {}
    if config.get("zones"):
        out["zone"] = f"z{i % config['zones']}"
    if config.get("hdd_every"):
        out["disk"] = "hdd" if i % config["hdd_every"] == 0 else "ssd"
    return out


def base_cluster(config: dict, seed: int) -> Base:
    """The configuration's nodes, services and residents (``residents_per_
    node`` on each node, drawn from ``resident_mix``; residents of one node
    never share a host port)."""
    n_nodes = config["nodes"]
    cap = config["node_capacity"]
    ns = config["namespace"]
    S = config["services"]
    nodes = [api.Node(
        metadata=api.ObjectMeta(
            name=f"node-{i:05d}", labels=_labels(config, i)),
        spec=api.NodeSpec(capacity={
            "cpu": Quantity(f"{cap['cpu_m']}m"),
            "memory": Quantity(f"{cap['memory_mi']}Mi")}))
        for i in range(n_nodes)]
    services = [api.Service(
        metadata=api.ObjectMeta(name=f"svc-{s}", namespace=ns),
        spec=api.ServiceSpec(port=80, selector={"app": f"app-{s}"}))
        for s in range(S)]
    per = config["residents_per_node"]
    E = n_nodes * per
    mix = draw_mix(config["resident_mix"], E, S, rng_for(seed, 0))
    port = mix["port"]
    if port.any():
        lo, hi = config["resident_mix"]["host_ports"]
        for n in range(n_nodes):
            used = set()
            for e in range(n * per, (n + 1) * per):
                while port[e] and port[e] in used:
                    port[e] = lo + (port[e] - lo + 1) % (hi - lo + 1)
                used.add(int(port[e]))
    res_node = np.repeat(np.arange(n_nodes, dtype=np.int64), per)
    residents = [
        _pod(f"res-{n:05d}-{e - n * per}", f"uid-res-{n:05d}-{e - n * per}",
             ns, _app(int(mix["service"][e])), int(mix["cpu"][e]),
             _mem_text(mix, e), int(port[e]), host=nodes[n].metadata.name)
        for e, n in enumerate(res_node.tolist())]
    plain = Cluster(
        node_names=[n.metadata.name for n in nodes],
        cap_cpu=np.full(n_nodes, cap["cpu_m"], np.int64),
        cap_mem=np.full(n_nodes, cap["memory_mi"] * _MI, np.int64),
        res_node=res_node, res_cpu=mix["cpu"], res_mem=mix["mem"],
        res_port=port, res_service=mix["service"], n_services=S)
    return Base(nodes, residents, services, ns, plain,
                {name: i for i, name in enumerate(plain.node_names)})


def make_pods(base: Base, mix: dict, names: List[str], uids: List[str],
              group: np.ndarray, group_names: List[str],
              group_size: int) -> Burst:
    """The pending pods of one wave, new objects, and their plain twin.
    ``group`` holds each pod's PodGroup index (-1: none), named by
    ``group_names``, each of ``group_size`` members."""
    cols = zip(names, uids, group.tolist(), mix["service"].tolist(),
               mix["cpu"].tolist(), mix["mem_mi"].tolist(),
               mix["mem_dec_mb"].tolist(), mix["port"].tolist())
    pods = []
    for name, uid, g, svc, cpu, mi, dec, port in cols:
        ann = ({gang_mod.GANG_NAME_ANNOTATION: group_names[g],
                gang_mod.GANG_MIN_MEMBERS_ANNOTATION: str(group_size)}
               if g >= 0 else None)
        pods.append(_pod(name, uid, base.namespace, _app(svc), cpu,
                         f"{dec}M" if dec else f"{mi}Mi", port,
                         annotations=ann))
    plain = Wave(keys=list(uids), cpu=mix["cpu"], mem=mix["mem"],
                 port=mix["port"], service=mix["service"],
                 group=np.asarray(group, np.int64))
    return Burst(pods, plain)
