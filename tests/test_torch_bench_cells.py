"""The benchmark's ``north_star.mixed_units`` and ``planet.burst`` cells
on the CPU.

``north_star.mixed_units`` (one pod in ten asking 500M of memory) is the
cell whose waves take the int64 planes; ``planet.burst`` (GKE's 65,000-node
limit, 2 residents a node, 2 services) is the one whose waves take the
thread-block cluster kernel and ServiceSpreading. At a cut
size the port's CPU path (the kernels' plain version) must equal the
benchmark's plain reference pod for pod; the published burst must pick the
planes each is there for; planet's width must stay in the cluster
kernel's domain, on a cluster of 16 blocks; and a traced wave must name
what ran, where the dispatch took its decision.
"""

import types

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.ops import commit_solver as cs
from kubernetes_tpu_torch.util import tracing
from portbench import manifest
from portbench.generators._cluster import base_cluster
from portbench.reference import scheduler as reference

# (cell, configuration overrides) of each shape; a cut size keeps the
# shape's residents a node and services
SHAPES = {
    "planet": ("planet.burst", {}),
    "north_star.mixed_units": ("north_star.mixed_units", {}),
    "north_star.burst": ("north_star.burst", {}),
}
CUT_NODES = {"planet": 300, "north_star.mixed_units": 200}
SEEDS = (3, 2**31 + 17, 4_200_000_011)


def _cell(shape, nodes=None, **traffic):
    """-> manifest.Cell of ``shape``, cut to ``nodes`` where given, the
    traffic's ``traffic`` keys overridden."""
    name, config = SHAPES[shape]
    config = dict(config)
    if nodes is not None:
        config["nodes"] = nodes
    return manifest.cell(name, {"config": config, "traffic": traffic})


def _waves(shape, seed, n=1, nodes=None, **traffic):
    """-> (base cluster, [burst, ...]) of ``shape``, cut to ``nodes`` (its
    CUT_NODES unless given) and ``traffic``."""
    c = _cell(shape, nodes or CUT_NODES[shape], **traffic)
    gen = manifest.module("generators", c.traffic["generator"])
    base = base_cluster(c.config, seed)
    return base, [gen.wave(base, c.config, c.traffic, seed, i)
                  for i in range(n)]


def _encode(base, burst):
    return encode_snapshot(base.nodes, base.residents, burst.pods,
                           base.services)


def _prepared(base, burst):
    snap = _encode(base, burst)
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
    return cs.prepare(inp, snap.policy, snap.has_gangs,
                      bs.peer_bound_of(snap))


@pytest.mark.parametrize("key,value", [
    ("nodes", 65_000), ("services", 2), ("residents_per_node", 2),
    ("node_capacity", {"cpu_m": 4000, "memory_mi": 32768}),
    ("reduced", [])])
def test_planet_is_north_star_at_gkes_node_limit(key, value):
    # planet keeps north_star's node and pod templates, guarantees and
    # burst, and changes only the cluster's size and its services
    planet, north_star = _cell("planet"), _cell("north_star.burst")
    assert planet.chips == 1
    assert planet.config[key] == value
    for same in ("node_capacity", "resident_mix", "namespace", "provider",
                 "guarantees"):
        assert planet.config[same] == north_star.config[same]
    assert {k: v for k, v in planet.traffic.items() if k != "why"} \
        == {k: v for k, v in north_star.traffic.items() if k != "why"}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", tuple(CUT_NODES))
def test_the_ports_cpu_path_equals_the_reference(shape, seed):
    base, bursts = _waves(shape, seed, n=2, pods=400)
    for burst in bursts:
        want, feasible = reference.solve(base.plain, burst.plain)
        snap = _encode(base, burst)
        chosen, _ = bs.solve(snap, device="cpu")
        assert np.array_equal(np.asarray(chosen, np.int64), want)
        assert feasible > 0 and (want >= 0).all()
        # the cut wave does the work its shape is there for
        if shape == "planet":
            assert sorted(set(burst.plain.service.tolist())) == [0, 1]
            assert snap.group_counts[:2].sum() == len(base.residents)
        else:
            assert np.count_nonzero(burst.plain.mem % (1 << 20)) \
                == len(burst.pods) // 10


@pytest.mark.parametrize("shape,planes", [
    ("north_star.burst", np.int32),
    ("north_star.mixed_units", np.int64),
    ("planet", np.int32),
])
def test_the_published_burst_picks_its_planes(shape, planes):
    # the choice of planes rests on the largest value on a node and the
    # whole burst's requests: a cut cluster of the same nodes and
    # residents a node, under the burst at its published 10,000 pods,
    # picks what the whole cluster picks
    assert _cell(shape).traffic["pods"] == 10_000
    base, (burst,) = _waves(shape, 5, nodes=200)
    host = bs.snapshot_to_host_inputs(_encode(base, burst))
    assert host.cap.dtype == planes and host.req.dtype == planes


def test_planet_takes_the_cluster_kernel_of_16_blocks():
    config = _cell("planet").config
    N, S = config["nodes"], config["services"]
    assert N == 65_000 <= cs.MAX_N
    # the widths of a planet wave, from a cut one; the peer counts from
    # the whole cluster: 65,000 residents a service, then the burst
    base, (burst,) = _waves("planet", 11)
    _n, R, Wp, Wd, G, B, res_bytes, _cnt = cs._dims(_prepared(base, burst))
    peers = N * config["residents_per_node"] // S
    cnt = cs.count_bytes_for(peers, 10_000)
    assert (R, res_bytes, cnt) == (2, 4, 4)
    assert cs.is_large(N, G, cnt)
    C, on_chip, nbytes = cs.cluster_for(N, R, Wp, Wd, G, B, res_bytes, cnt,
                                        max_cluster=16)
    S = cs.slice_nodes(N, C)
    assert (C, S) == (16, 4_064)
    # the 2 services pad to 8 groups of int32 counts: a slice's planes
    # (268,224 B a block) pass the 222,208 B a block has beside the
    # kernel's static arrays, so they live in global memory and a block
    # keeps only its mask ring on chip
    room = cs.SMEM_PER_BLOCK - cs.CLUSTER_STATIC_SMEM
    assert G == 8
    assert cs.cluster_bytes(N, C, R, Wp, Wd, G, 0, B, res_bytes, cnt) \
        == 268_224 > room
    assert not on_chip and nbytes == 2 * S


def test_planet_names_its_65000_nodes_apart():
    config = dict(_cell("planet").config, residents_per_node=0)
    base = base_cluster(config, 1)
    names = base.plain.node_names
    assert len(set(names)) == 65_000
    assert names[0] == "node-00000" and names[-1] == "node-64999"
    assert names == sorted(names)
    assert base.node_index["node-64999"] == 64_999


def _traced(fn):
    """-> the kube-trace spans ``fn()`` records."""
    tracing.enable("test")
    try:
        tracing.drain()
        fn()
        return tracing.drain()["spans"]
    finally:
        tracing.disable()


@pytest.mark.parametrize("shape,services", [
    ("planet", 2), ("north_star.mixed_units", 0)])
def test_a_traced_wave_names_what_ran_and_its_services(shape, services):
    base, (burst,) = _waves(shape, 7)
    calls = cs.solve_commit.calls
    spans = _traced(lambda: bs.solve(_encode(base, burst), device="cpu"))
    # inside the kernel's domain: solve_commit, whose plain version runs
    # on a CPU tensor
    assert cs.solve_commit.calls == calls + 1
    (commit,) = [s for s in spans if s["name"] == "solve.commit"]
    assert commit["attrs"] == {"instance": "plain"}
    (scatter,) = [s for s in spans if "rows" in s["attrs"]]
    assert scatter["name"] == "encode.residents"
    assert scatter["attrs"]["services"] == services
    assert scatter["attrs"]["labels"] == int(services > 0)


def test_a_wave_the_dispatch_refuses_is_named_plain():
    # 40 distinct resident priorities under a higher-priority burst pad
    # to 64 band slots, past MAX_B: eligible refuses the wave, which runs
    # solve_scan; its one solve.commit span says so
    base, (burst,) = _waves("north_star.mixed_units", 9, nodes=50,
                            pods=40)
    for k, p in enumerate(base.residents):
        p.spec.priority = k % 40
    for p in burst.pods:
        p.spec.priority = 100
    snap = _encode(base, burst)
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
    assert not cs.eligible(inp, snap.policy, bs.peer_bound_of(snap))
    calls = cs.solve_commit.calls
    plain = cs.solve_commit_reference.calls
    spans = _traced(lambda: bs.solve(snap, device="cpu"))
    assert cs.solve_commit.calls == calls
    assert cs.solve_commit_reference.calls == plain + 1
    (commit,) = [s for s in spans if s["name"] == "solve.commit"]
    assert commit["attrs"] == {"instance": "plain"}


class _FakeLib:
    """The kernel library's C interface, launching nothing: every call
    succeeds, and the card schedules clusters of 16 blocks."""

    def kgpu_commit_solve_cluster_limit(self, *args):
        args[-1]._obj.value = 16
        return 0

    def kgpu_commit_solve_cluster(self, *args):
        return 0

    def kgpu_commit_solve_batch(self, *args):
        return 0


@pytest.mark.parametrize("planes,launch,want", [
    (32, "stacked", "commit_solve<int32,"),
    (32, "cluster", "commit_solve_large<int32,counts16,shared,c4>"),
    (64, "stacked", "commit_solve<int64,"),
    (64, "cluster", "commit_solve_large<int64,counts16,shared,c16>"),
])
def test_each_launch_names_its_instance(monkeypatch, planes, launch, want):
    monkeypatch.setattr(cs, "_lib", _FakeLib)
    monkeypatch.setattr(cs, "_card_cluster", None)
    monkeypatch.setattr(cs.solve_commit, "instances", set())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda _dev=None: types.SimpleNamespace(
                            cuda_stream=0))
    if planes == 64:
        base, (burst,) = _waves("north_star.mixed_units", 2)
    else:
        base, (burst,) = _waves("planet", 2, pods=16)
    ci = _prepared(base, burst)
    assert ci.cap.element_size() * 8 == planes
    if launch == "stacked":
        # two waves of one key: the batched instance
        name = cs.instance_of(ci, 2)
        run = lambda: cs.launch_stacked(  # noqa: E731
            ci, cs.stack_planes([ci, ci]), 2)
    else:
        C = 4 if planes == 32 else None
        name = cs.instance_of(ci, cluster=C or 16)
        run = lambda: cs.launch_cluster(ci, C)  # noqa: E731
    assert name.startswith(want)
    launches = cs.solve_commit.launches
    spans = _traced(run)
    (commit,) = [s for s in spans if s["name"] == "solve.commit"]
    assert commit["attrs"] == {"instance": name}
    assert cs.solve_commit.instances == {name}
    assert cs.solve_commit.launches == launches + 1
