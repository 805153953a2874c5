"""The port's kube-solverd (solver/) against the JAX package's, on the CPU.

Every case of tests/test_solverd.py runs against the port's daemon and
client with ``device="cpu"`` (the kernel's plain version): protocol round
trips, the daemon's lifecycle and version skew, remote solves bit-identical
to the in-process solve, concurrent waves coalescing into one device call
(zone vocabularies included), BUSY and the fallback, an absent daemon and
its cooldown, a restart behind a stale pooled connection, the whole delta
wire, and the port's BatchScheduler solving through the daemon. The two
packages also meet on the wire: a port client against the reference
daemon and the reference client against the port's daemon decide alike,
``send_msg`` writes the same bytes, and equal policies give equal
fingerprints. The five prewarm cases of tests/test_slipstream.py run
against the port's PrewarmController, and on seeded waves of each family
the batched plain version equals each wave's own solve, padded to the
group's per-axis maximum or not. Every daemon stops in a ``finally``;
every socket wait has a timeout.
"""

import dataclasses
import random
import socket
import threading
import time

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu.models.batch_solver import solve as ref_solve
from kubernetes_tpu.models.batch_solver import \
    snapshot_to_host_inputs as ref_host_inputs
from kubernetes_tpu.models.policy import BatchPolicy as RefPolicy
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.solver import protocol as ref_protocol
from kubernetes_tpu.solver.client import RemoteSolver as RefRemoteSolver
from kubernetes_tpu.solver.service import SolverService as RefSolverService
from kubernetes_tpu_torch.cmd import solverd as port_solverd
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.models.policy import BatchPolicy, batch_policy_from
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.parallel import mesh as port_mesh
from kubernetes_tpu_torch.scheduler import driver as port_driver
from kubernetes_tpu_torch.scheduler.plugins import (Policy, PolicyPredicate,
                                                    PolicyPriority)
from kubernetes_tpu_torch.scheduler.tpu_batch import BatchScheduler
from kubernetes_tpu_torch.solver import protocol
from kubernetes_tpu_torch.solver.client import (RemoteSolver, SolverBusy,
                                                SolverUnavailable)
from kubernetes_tpu_torch.solver.prewarm import PrewarmController, pow2_ladder
from kubernetes_tpu_torch.solver.service import (SolverService, _dims_of,
                                                 _pad_inputs, _target_dims)
from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster
from kubernetes_tpu_torch.util import metrics
from test_pipeline import N_NODES, N_PODS, WAVE, run_stack
from test_pipeline import mk_node as pipe_node
from test_pipeline import mk_pod as pipe_pod
from test_solverd import SERVICES as REF_SERVICES
from test_solverd import mk_node, mk_pod
from test_torch_policy import to_port
from test_torch_twin import mesh_on_the_cpu

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)

SERVICES = to_port(REF_SERVICES)
CPU = "cpu"


def _solver(addr, **kw):
    """A port client for the tests: the CPU, no fallback unless asked, a
    reply deadline well inside the test's own."""
    kw.setdefault("fallback", False)
    kw.setdefault("timeout_s", 60)
    return RemoteSolver(addr, device=CPU, **kw)


def _service(**kw):
    return SolverService(device=CPU, **kw)


def _stop(srv):
    srv.stop()
    assert srv.join(10.0)


def port_snapshot(tag="x", n_nodes=5, n_pods=9):
    """test_solverd.small_snapshot's wave, encoded by the port."""
    nodes = [mk_node(f"{tag}-n{i}") for i in range(n_nodes)]
    pending = [mk_pod(f"{tag}-p{j}", port=7000 + j if j % 3 == 0 else 0)
               for j in range(n_pods)]
    return encode_snapshot(to_port(nodes), [], to_port(pending), SERVICES)


def solve(snap):
    return bs.solve(snap, device=CPU)


def _same(got, want):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def _rebind_port(srv_cls, port, **kw):
    """A daemon on ``port`` once the old socket is torn down."""
    deadline = time.monotonic() + 10
    while True:
        try:
            return srv_cls(port=port, **kw)
        except OSError:   # old socket still tearing down
            assert time.monotonic() < deadline, "port never freed"
            time.sleep(0.1)


# -- protocol ----------------------------------------------------------------

class TestProtocol:
    def test_frame_roundtrip_with_arrays(self):
        a, b = socket.socketpair()
        a.settimeout(10)
        b.settimeout(10)
        try:
            arrays = (np.arange(12, dtype=np.int32).reshape(3, 4),
                      np.array([True, False, True]),
                      np.zeros((0, 7), np.uint32))
            protocol.send_msg(a, {"op": "solve", "v": 1}, arrays)
            header, got = protocol.recv_msg(b)
            assert header["op"] == "solve"
            assert len(got) == 3
            for x, y in zip(arrays, got):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert np.array_equal(x, y)
            assert got[0].flags.writeable
        finally:
            a.close()
            b.close()

    def test_policy_wire_roundtrip(self):
        pol = BatchPolicy(
            use_disk=False,
            label_presence=((("region",), True), (("gpu", "tpu"), False)),
            affinity_labels=("rack",),
            w_lr=2, w_spread=0, w_equal=1,
            label_prefs=(("ssd", True, 3),),
            anti_affinity=(("zone", 2),))
        back = protocol.policy_from_wire(protocol.policy_to_wire(pol))
        assert back == pol
        assert hash(back) == hash(pol)

    def test_fingerprint_binds_policy_and_gangs(self):
        p1, p2 = BatchPolicy(), BatchPolicy(w_lr=2)
        assert protocol.solver_fingerprint(p1, False) == \
            protocol.solver_fingerprint(BatchPolicy(), False)
        assert protocol.solver_fingerprint(p1, False) != \
            protocol.solver_fingerprint(p2, False)
        assert protocol.solver_fingerprint(p1, False) != \
            protocol.solver_fingerprint(p1, True)

    def test_eof_returns_none(self):
        a, b = socket.socketpair()
        b.settimeout(10)
        a.close()
        try:
            assert protocol.recv_msg(b) is None
        finally:
            b.close()


# -- the two packages on one wire --------------------------------------------

_WIRE_POLICIES = [
    {},
    dict(use_disk=False, w_lr=2, w_spread=0, w_equal=1),
    dict(label_presence=((("region",), True), (("gpu", "tpu"), False)),
         affinity_labels=("rack",), label_prefs=(("ssd", True, 3),),
         anti_affinity=(("zone", 2), ("rack", 1))),
    dict(all_infeasible=True, w_lr=0, w_spread=0),
]


@pytest.mark.parametrize("kw", _WIRE_POLICIES)
def test_policy_wire_and_fingerprint_equal_the_reference(kw):
    ours, theirs = BatchPolicy(**kw), RefPolicy(**kw)
    assert protocol.policy_to_wire(ours) == \
        ref_protocol.policy_to_wire(theirs)
    assert protocol.policy_from_wire(
        ref_protocol.policy_to_wire(theirs)) == ours
    for gangs in (False, True):
        for v in (1, 2, 3):
            assert protocol.solver_fingerprint(ours, gangs, v) == \
                ref_protocol.solver_fingerprint(theirs, gangs, v)


def test_protocol_constants_equal_the_reference():
    assert (protocol.PROTOCOL_VERSION, protocol.MIN_PROTOCOL_VERSION,
            protocol.MAX_FRAME, protocol.DELTA_FIELDS) == (
        ref_protocol.PROTOCOL_VERSION, ref_protocol.MIN_PROTOCOL_VERSION,
        ref_protocol.MAX_FRAME, ref_protocol.DELTA_FIELDS)
    header = {"trace": ["a" * 16, "b" * 8]}
    assert protocol.parse_trace(header) == ref_protocol.parse_trace(header)
    assert protocol.parse_trace({"trace": [1, 2]}) is None


def _frame_bytes(send, header, arrays):
    a, b = socket.socketpair()
    b.settimeout(10)
    try:
        send(a, header, arrays)
        a.close()
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        b.close()


@pytest.mark.parametrize("which", ["small", "wave"])
def test_send_msg_bytes_equal_the_reference(which):
    if which == "small":
        header = {"op": "solve", "v": 3, "planes": ["F", "S", ["D", 2]],
                  "cache": {"wid": "w.1", "bucket": "ab", "epoch": 4}}
        arrays = (np.arange(6, dtype=np.uint32).reshape(2, 3),
                  np.zeros((0, 4), np.int64), np.array([True, False]))
    else:
        snap = port_snapshot("bytes", 6, 11)
        host = bs.snapshot_to_host_inputs(snap)
        header = {"op": "solve", "v": protocol.PROTOCOL_VERSION,
                  "fp": protocol.solver_fingerprint(BatchPolicy(), False),
                  "policy": protocol.policy_to_wire(BatchPolicy()),
                  "gangs": False}
        arrays = tuple(host)
    ours = _frame_bytes(protocol.send_msg, header, arrays)
    theirs = _frame_bytes(ref_protocol.send_msg, header, arrays)
    assert ours == theirs and len(ours) > 8


def test_host_inputs_ship_as_the_reference_ships_them():
    """The same wave encoded by each package gives the same frame arrays
    (dtype strings and bytes): a port client's frame is one the
    reference daemon reads as its own."""
    nodes = [mk_node(f"h-n{i}") for i in range(5)]
    pending = [mk_pod(f"h-p{j}", port=7000 if j % 3 == 0 else 0)
               for j in range(9)]
    ref_host = ref_host_inputs(ref_encode(nodes, [], pending, REF_SERVICES))
    host = bs.snapshot_to_host_inputs(encode_snapshot(
        to_port(nodes), [], to_port(pending), SERVICES))
    assert host._fields == ref_host._fields
    for name, a, b in zip(host._fields, host, ref_host):
        b = np.asarray(b)
        assert str(a.dtype) == str(b.dtype), name
        assert a.shape == b.shape and np.array_equal(a, b), name
    assert protocol.shape_bucket(host) == ref_protocol.shape_bucket(
        tuple(np.asarray(b) for b in ref_host))


def test_port_client_against_the_reference_daemon():
    """A port RemoteSolver (delta wire on) ships the port's encodes to the
    JAX package's daemon: each reply equals the port's in-process solve,
    over a full frame and then deltas."""
    srv = RefSolverService(gather_window_s=0.001).start()
    try:
        cli = _solver(srv.address, timeout_s=120)
        for snap in _churn_stream("xref", waves=3):
            _same(cli.solve(snap), solve(snap))
        assert (cli.full_waves, cli.delta_waves, cli.resync_waves) == \
            (1, 2, 0)
    finally:
        srv.stop()


def test_reference_client_against_the_port_daemon():
    """The JAX package's RemoteSolver against the port's daemon: each
    reply equals the reference's in-process solve, full frame, then
    deltas; a gang wave too."""
    from kubernetes_tpu.models.incremental import \
        IncrementalEncoder as RefEncoder
    from test_solverd import TestDeltaWire

    srv = _service(gather_window_s=0.001).start()
    try:
        cli = RefRemoteSolver(srv.address, fallback=False, timeout_s=120)
        waves = 0
        for snap in TestDeltaWire._churn_stream("rxp", waves=3):
            want = ref_solve(snap)
            got = cli.solve(snap)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
            waves += 1
        assert (cli.full_waves, cli.delta_waves) == (1, 2)
        nodes = [mk_node(f"rg{i}", cpu="2") for i in range(4)]
        pending = [mk_pod(f"rgp{g}-{m}", cpu="900m", group=f"grp{g}",
                          gsize=3) for g in range(3) for m in range(3)]
        snap = RefEncoder().encode(nodes, [], pending, REF_SERVICES)
        assert snap.has_gangs
        got, want = cli.solve(snap), ref_solve(snap)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert srv.waves_served == waves + 1
    finally:
        _stop(srv)


# -- daemon lifecycle --------------------------------------------------------

class TestDaemonLifecycle:
    def test_start_ping_stop(self):
        srv = _service().start()
        addr = srv.address
        try:
            pong = _solver(addr).ping()
            assert pong["v"] == protocol.PROTOCOL_VERSION
            assert pong["solves"] == 0
        finally:
            _stop(srv)
        cli2 = _solver(addr, connect_timeout_s=0.3)
        with pytest.raises(SolverUnavailable):
            cli2.ping()

    def test_version_skew_rejected(self):
        srv = _service().start()
        try:
            sock = socket.create_connection(
                ("127.0.0.1", srv.port), timeout=10)
            sock.settimeout(10)
            host = bs.snapshot_to_host_inputs(port_snapshot("skew", 3, 2))
            protocol.send_msg(sock, {
                "op": "solve", "v": 999,
                "policy": protocol.policy_to_wire(BatchPolicy()),
                "gangs": False}, tuple(host))
            header, _ = protocol.recv_msg(sock)
            assert "err" in header and "version skew" in header["msg"]
            sock.close()
        finally:
            _stop(srv)

    def test_mesh_on_refused_naming_its_roadmap_item(self, monkeypatch):
        """``mesh="on"`` as the reference's: a host with one device
        refuses it, ``auto`` there builds no executor, and eight CPU
        shards build the mesh executor."""
        monkeypatch.setattr(port_mesh, "default_devices",
                            lambda: [torch.device("cpu")])
        with pytest.raises(port_mesh.MeshUnavailable, match=">1 device"):
            _service(mesh="on")
        srv = _service(mesh="auto")
        assert srv._mesh_exec is None
        _stop(srv)
        mesh_on_the_cpu(monkeypatch)
        srv = _service(mesh="on", mesh_min_nodes=1)
        try:
            assert srv._mesh_exec is not None
            assert srv._mesh_exec.node_shards == 8
            assert srv._mesh_exec.min_nodes == 1
        finally:
            _stop(srv)


# -- solve correctness -------------------------------------------------------

class TestRemoteSolve:
    def test_bit_identical_to_in_process(self):
        snap = port_snapshot("solo", 6, 11)
        expected = solve(snap)
        srv = _service(gather_window_s=0.005).start()
        try:
            cli = _solver(srv.address)
            _same(cli.solve(snap), expected)
            assert cli.remote_waves == 1 and srv.solve_calls == 1
            assert srv.batched_solves == 1 and srv.scan_waves == 0
        finally:
            _stop(srv)

    def test_gang_wave_bit_identical(self):
        nodes = [mk_node(f"gg{i}", cpu="2") for i in range(4)]
        pending = [mk_pod(f"gp{g}-{m}", cpu="900m", group=f"grp{g}",
                          gsize=3) for g in range(3) for m in range(3)]
        snap = encode_snapshot(to_port(nodes), [], to_port(pending),
                               SERVICES)
        assert snap.has_gangs
        expected = solve(snap)
        srv = _service(gather_window_s=0.005).start()
        try:
            _same(_solver(srv.address).solve(snap), expected)
        finally:
            _stop(srv)

    def test_wave_outside_the_kernel_domain_runs_the_scan(self):
        """A wave the kernel does not take (all priorities zero) runs
        solve_scan on the daemon's device, as solve_device sends it."""
        pol = BatchPolicy(w_lr=0, w_spread=0, all_infeasible=True)
        nodes = [mk_node(f"sc-n{i}") for i in range(3)]
        snap = encode_snapshot(to_port(nodes), [],
                               to_port([mk_pod("sc-p0"), mk_pod("sc-p1")]),
                               SERVICES, policy=pol)
        srv = _service(gather_window_s=0.005).start()
        try:
            _same(_solver(srv.address).solve(snap), solve(snap))
            assert srv.scan_waves == 1 and srv.batched_solves == 0
        finally:
            _stop(srv)


# -- wave coalescing ---------------------------------------------------------

def _concurrently(srv, snaps, **kw):
    """Each snapshot from its own client thread -> replies in order."""
    results = [None] * len(snaps)
    errors = []

    def worker(i):
        try:
            results[i] = _solver(srv.address, **kw).solve(snaps[i])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(snaps))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


class TestCoalescing:
    def test_concurrent_waves_coalesce_and_stay_bit_identical(self):
        shapes = [(5, 9, False), (7, 13, True), (3, 4, False),
                  (11, 20, True), (5, 9, False), (6, 17, True)]
        snaps = []
        for k, (nn, pp, incremental) in enumerate(shapes):
            nodes = to_port([mk_node(f"c{k}-n{i}") for i in range(nn)])
            pending = to_port([mk_pod(f"c{k}-p{j}",
                                      port=7100 + j if j % 3 == 0 else 0)
                               for j in range(pp)])
            if incremental:
                snaps.append(IncrementalEncoder().encode(
                    nodes, [], pending, SERVICES))
            else:
                snaps.append(encode_snapshot(nodes, [], pending, SERVICES))
        expected = [solve(s) for s in snaps]
        srv = _service(gather_window_s=0.5, max_batch=16).start()
        try:
            results = _concurrently(srv, snaps)
            assert srv.waves_served == len(snaps)
            assert srv.solve_calls < len(snaps), (
                f"{srv.solve_calls} device calls for {len(snaps)} waves: "
                "no coalescing happened")
            for i, (got, want) in enumerate(zip(results, expected)):
                _same(got, want)
        finally:
            _stop(srv)

    def test_zone_anti_affinity_waves_coalesce_across_zone_vocabs(self):
        pol = Policy(
            predicates=[PolicyPredicate(name=n) for n in
                        ("PodFitsPorts", "PodFitsResources",
                         "NoDiskConflict", "MatchNodeSelector", "HostName")],
            priorities=[
                PolicyPriority(name="LeastRequestedPriority", weight=1),
                PolicyPriority(name="zoneSpread", weight=2,
                               service_anti_affinity_label="zone")])
        bp = batch_policy_from(policy=pol)
        n1 = [mk_node(f"za-{i}", labels={"zone": f"z{i % 2}"})
              for i in range(6)]
        n2 = [mk_node(f"zb-{i}", labels={"zone": f"z{i % 5}"})
              for i in range(9)]
        s1 = encode_snapshot(to_port(n1), [],
                             to_port([mk_pod(f"zap{j}") for j in range(7)]),
                             SERVICES, policy=bp)
        s2 = encode_snapshot(to_port(n2), [],
                             to_port([mk_pod(f"zbp{j}") for j in range(11)]),
                             SERVICES, policy=bp)
        expected = [solve(s1), solve(s2)]
        srv = _service(gather_window_s=0.5, max_batch=8).start()
        try:
            results = _concurrently(srv, [s1, s2])
            assert srv.solve_calls == 1, "zone waves did not coalesce"
            for got, want in zip(results, expected):
                _same(got, want)
        finally:
            _stop(srv)


# -- backpressure ------------------------------------------------------------

class TestBackpressure:
    def test_busy_when_queue_full_and_fallback_recovers(self):
        snap = port_snapshot("busy", 4, 3)
        expected = solve(snap)
        srv = _service(gather_window_s=0.001, max_batch=1, max_queue=1)
        entered = threading.Event()
        release = threading.Event()
        real_solve = srv._device_solve

        def slow_solve(stacked, pol, gangs):
            entered.set()
            assert release.wait(timeout=60)
            return real_solve(stacked, pol, gangs)

        srv._device_solve = slow_solve
        srv.start()
        try:
            results = {}

            def req(name):
                results[name] = _solver(srv.address).solve(snap)

            t1 = threading.Thread(target=req, args=("first",))
            t1.start()
            assert entered.wait(timeout=60)
            t2 = threading.Thread(target=req, args=("second",))
            t2.start()
            deadline = time.monotonic() + 10
            while len(srv._pending) < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(srv._pending) == 1
            with pytest.raises(SolverBusy):
                _solver(srv.address, timeout_s=30).solve(snap)
            # a fallback client solves in its own process, bit-identically,
            # without entering the unhealthy cooldown (busy != dead)
            soft = _solver(srv.address, timeout_s=30, fallback=True)
            _same(soft.solve(snap), expected)
            assert soft.busy_waves == 1 and not soft._in_cooldown()
            release.set()
            t1.join(timeout=60)
            t2.join(timeout=60)
            assert not t1.is_alive() and not t2.is_alive()
            _same(results["first"], expected)
            _same(results["second"], expected)
        finally:
            release.set()
            _stop(srv)


# -- client fallback ---------------------------------------------------------

class TestFallback:
    def test_daemon_absent_falls_back_and_cools_down(self):
        snap = port_snapshot("dead", 4, 5)
        expected = solve(snap)
        cli = _solver("127.0.0.1:1", connect_timeout_s=0.2,
                      cooldown_s=30.0, fallback=True)
        t0 = time.monotonic()
        _same(cli.solve(snap), expected)
        first_s = time.monotonic() - t0
        assert cli.fallback_waves == 1 and cli._in_cooldown()
        t0 = time.monotonic()
        _same(cli.solve(snap), expected)
        assert time.monotonic() - t0 < first_s + 0.5
        assert cli.fallback_waves == 2

    def test_no_fallback_raises(self):
        cli = _solver("127.0.0.1:1", connect_timeout_s=0.2)
        with pytest.raises(SolverUnavailable):
            cli.solve(port_snapshot("strict", 3, 2))

    def test_daemon_restart_retries_stale_pooled_connection(self):
        snap = port_snapshot("restart", 4, 5)
        expected = solve(snap)
        srv1 = _service(gather_window_s=0.005).start()
        port = srv1.port
        cli = _solver(srv1.address)
        _same(cli.solve(snap), expected)
        _stop(srv1)
        srv2 = _rebind_port(SolverService, port, gather_window_s=0.005,
                            device=CPU)
        srv2.start()
        try:
            _same(cli.solve(snap), expected)
            assert cli.remote_waves == 2 and not cli._in_cooldown()
        finally:
            _stop(srv2)

    def test_fallback_runs_on_the_clients_device(self):
        """The fallback solve is the in-process one on the client's own
        device: with the default device the client needs a card."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RemoteSolver("127.0.0.1:1")


# -- the delta wire (protocol v2) --------------------------------------------

def _churn_stream(tag, waves=5, n_nodes=6, wave_pods=5):
    """One port incremental encoder churning (test_solverd's stream): each
    wave's resident planes differ from the last by the rows its binds
    touched, in one shape bucket."""
    enc = IncrementalEncoder()
    nodes = to_port([mk_node(f"{tag}-n{i}") for i in range(n_nodes)])
    existing = []
    for w in range(waves):
        pending = to_port([mk_pod(f"{tag}-w{w}p{j}")
                           for j in range(wave_pods)])
        snap = enc.encode(nodes, existing, pending, SERVICES)
        yield snap
        chosen, _ = solve(snap)
        for p, h in zip(pending, bs.decisions_to_names(snap, chosen)):
            if h:
                p.status.host = h
                existing.append(p)


class TestDeltaWire:
    def test_delta_stream_bit_identical_to_full_and_in_process(self):
        srv = _service(gather_window_s=0.001).start()
        try:
            cli_delta = _solver(srv.address)
            cli_full = _solver(srv.address, delta=False)
            for snap in _churn_stream("dw"):
                expected = solve(snap)
                _same(cli_delta.solve(snap), expected)
                _same(cli_full.solve(snap), expected)
            assert cli_delta.full_waves == 1
            assert cli_delta.delta_waves == 4
            assert cli_delta.resync_waves == 0
            assert srv.delta_waves == 4
            assert cli_delta.delta_bytes_shipped < cli_delta.delta_bytes_full
            assert cli_full.delta_waves == 0 and cli_full.full_waves == 0
        finally:
            _stop(srv)

    def test_epoch_skew_resyncs_and_recovers(self):
        srv = _service(gather_window_s=0.001).start()
        try:
            cli = _solver(srv.address)
            snaps = list(_churn_stream("ep"))
            expected = [solve(s) for s in snaps]
            _same(cli.solve(snaps[0]), expected[0])
            for mir in cli._local.mirrors.values():
                mir.epoch += 3
            _same(cli.solve(snaps[1]), expected[1])
            assert cli.resync_waves == 1 and srv.resync_replies == 1
            _same(cli.solve(snaps[2]), expected[2])
            assert cli.delta_waves == 1
        finally:
            _stop(srv)

    def test_daemon_restart_mid_stream_resyncs_no_cache(self):
        snaps = list(_churn_stream("rs"))
        expected = [solve(s) for s in snaps]
        srv1 = _service(gather_window_s=0.001).start()
        port = srv1.port
        cli = _solver(srv1.address)
        for i in (0, 1):
            _same(cli.solve(snaps[i]), expected[i])
        assert cli.delta_waves == 1
        _stop(srv1)
        srv2 = _rebind_port(SolverService, port, gather_window_s=0.001,
                            device=CPU)
        srv2.start()
        try:
            _same(cli.solve(snaps[2]), expected[2])
            assert cli.resync_waves == 1
            _same(cli.solve(snaps[3]), expected[3])
            assert cli.delta_waves == 2
        finally:
            _stop(srv2)

    def test_v1_full_frame_client_still_served(self):
        snap = port_snapshot("v1c", 4, 6)
        expected = solve(snap)
        srv = _service(gather_window_s=0.001).start()
        try:
            sock = socket.create_connection(("127.0.0.1", srv.port),
                                            timeout=10)
            sock.settimeout(60)
            protocol.send_msg(sock, {
                "op": "solve", "v": 1,
                "fp": protocol.solver_fingerprint(BatchPolicy(), False,
                                                  version=1),
                "policy": protocol.policy_to_wire(BatchPolicy()),
                "gangs": False}, tuple(bs.snapshot_to_host_inputs(snap)))
            header, arrays = protocol.recv_msg(sock)
            assert header.get("ok"), header
            assert np.array_equal(arrays[0], expected[0])
            sock.close()
        finally:
            _stop(srv)

    def test_shape_bucket_tracks_layout(self):
        a = (np.zeros((4, 2), np.int32), np.ones(3, bool))
        same = (np.ones((4, 2), np.int32) * 7, np.zeros(3, bool))
        grown = (np.zeros((8, 2), np.int32), np.ones(3, bool))
        widened = (np.zeros((4, 2), np.int64), np.ones(3, bool))
        assert protocol.shape_bucket(a) == protocol.shape_bucket(same)
        assert protocol.shape_bucket(a) != protocol.shape_bucket(grown)
        assert protocol.shape_bucket(a) != protocol.shape_bucket(widened)
        assert protocol.shape_bucket(a) == ref_protocol.shape_bucket(a)

    def test_delta_metrics_family(self):
        dm = metrics.solverd_delta_metrics()
        h0, f0 = dm.hits.total(), dm.full_frames.total()
        srv = _service(gather_window_s=0.001).start()
        try:
            cli = _solver(srv.address)
            for snap in _churn_stream("dm", waves=3):
                cli.solve(snap)
        finally:
            _stop(srv)
        assert (dm.hits.total() - h0, dm.full_frames.total() - f0) == (2, 1)
        text = metrics.default_registry().render_text()
        for name in ("solverd_delta_hits_total",
                     "solverd_delta_bytes_saved_total",
                     "solverd_coalesced_waves_total",
                     "solverd_device_solves_total"):
            assert f"# TYPE {name} " in text, name


# -- the scheduler end-to-end ------------------------------------------------

def _fake_stack(solver_addr=""):
    """The port's causal loop over a FakeClient cluster holding
    test_pipeline's nodes and backlog, synced before the first drain ->
    the final {pod name: host} map and the scheduler."""
    cluster = FakeCluster(to_port([pipe_node(i) for i in range(N_NODES)]),
                          [], to_port([pipe_pod(i) for i in range(N_PODS)]),
                          [])
    factory = port_driver.ConfigFactory(cluster.client,
                                        node_poll_period=3600)
    cluster.attach(factory)
    config = factory.create(solver_addr=solver_addr)
    assert config.solver_addr == solver_addr
    sched = BatchScheduler(config, factory, cluster.client, wave_size=WAVE,
                           wave_linger_s=0.01, device=CPU)
    try:
        cluster.wait_synced()
        while True:
            try:
                sched.schedule_wave(timeout=0)
            except TimeoutError:
                break
        placement = {p.metadata.name: p.spec.host for p in cluster.bound()}
        assert len(placement) == N_PODS and all(placement.values())
        return placement, sched
    finally:
        assert factory.stop(join=True)


def test_batch_scheduler_through_solverd():
    """The port's BatchScheduler built from ``solver_addr`` solves every
    wave on the daemon; its placements equal the port's in-process causal
    loop's and the JAX package's loop (test_pipeline.run_stack)."""
    srv = _service(gather_window_s=0.005).start()
    try:
        remote, sched = _fake_stack(srv.address)
        assert isinstance(sched.solver, RemoteSolver)
        assert sched.solver.remote_waves == N_PODS // WAVE
        assert sched.solver.fallback_waves == 0
        assert srv.waves_served == sched.solver.remote_waves
    finally:
        _stop(srv)
    local, sched = _fake_stack()
    assert sched.solver is None
    assert remote == local == run_stack(pipeline=False)


# -- prewarm (tests/test_slipstream.py's cases) ------------------------------

class _Recorder:
    def __init__(self, fail=False, gate=None):
        self.targets = []
        self.fail = fail
        self.gate = gate

    def __call__(self, target):
        if self.gate is not None:
            assert self.gate.wait(5.0)
        self.targets.append(dict(target))
        if self.fail:
            raise RuntimeError("injected compile failure")


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_pow2_ladder():
    assert pow2_ladder(1000, floor=256) == [1024, 512, 256]
    assert pow2_ladder(256, floor=256) == [256]
    assert pow2_ladder(0) == []


def test_prewarm_fill_trigger_queues_next_bucket():
    rec = _Recorder()
    c = PrewarmController(rec, fill_fraction=0.75).start()
    try:
        bucket = {"N": 32, "N1": 33, "P": 16}
        c.observe({"P": 11}, bucket)
        assert c.pending() == 0
        c.observe({"P": 12}, bucket, frozen=("P",))
        assert c.pending() == 0
        c.observe({"P": 12}, bucket)
        assert _wait(lambda: c.compiled == 1)
        assert rec.targets == [{"N": 32, "N1": 33, "P": 32}]
        c.observe({"P": 13}, bucket)
        c.observe({"N": 31, "P": 2}, bucket)
        assert _wait(lambda: c.compiled == 2)
        assert rec.targets[1] == {"N": 64, "N1": 65, "P": 16}
    finally:
        c.stop()


def test_prewarm_boot_set_ready_gate():
    gate = threading.Event()
    rec = _Recorder(gate=gate)
    sx = metrics.slipstream_metrics()
    c = PrewarmController(rec).start()
    try:
        assert not c.ready()
        n = c.boot_set([{"N": 32, "N1": 33, "P": p}
                        for p in pow2_ladder(128, floor=64)])
        assert n == 2
        assert not c.ready() and sx.prewarm_ready.value() == 0.0
        gate.set()
        assert _wait(lambda: c.ready())
        assert c.compiled == 2 and sx.prewarm_ready.value() == 1.0
        c2 = PrewarmController(_Recorder())
        c2.boot_set([])
        assert c2.ready()
    finally:
        c.stop()


def test_prewarm_compile_failure_is_contained():
    rec = _Recorder(fail=True)
    c = PrewarmController(rec).start()
    try:
        c.boot_set([{"P": 64}])
        assert _wait(lambda: c.errors == 1)
        assert c.compiled == 0
        assert c.ready()
        assert not c.submit({"P": 64})
        rec.fail = False
        assert c.submit({"P": 128})
        assert _wait(lambda: c.compiled == 1)
    finally:
        c.stop()


def test_prewarm_swap_under_load():
    """Live waves racing the daemon's prewarm launches for bigger buckets
    return the unraced decisions: the prewarm runs on the solver thread,
    between groups, and every bucket it queued ran."""
    snap = port_snapshot("swap", 3, 4)
    ref = solve(snap)
    host = bs.snapshot_to_host_inputs(snap)
    srv = _service(gather_window_s=0.001)
    srv._prewarm_exemplar = (host, BatchPolicy(), False)
    srv.start()
    try:
        targets = []
        for k in (2, 4, 8):
            t = dict(_dims_of(host))
            t["P"] *= k
            t["N1"] = t["N"] + 1
            t["BATCH"] = k
            targets.append(t)
        assert srv._prewarm.boot_set(targets) == 3
        cli = _solver(srv.address)
        deadline = time.monotonic() + 30.0
        while not srv._prewarm.ready() and time.monotonic() < deadline:
            _same(cli.solve(snap), ref)
        assert srv._prewarm.ready() and srv._prewarm.errors == 0
        assert srv.prewarm_launches >= 3
        _same(cli.solve(snap), ref)
    finally:
        _stop(srv)


def test_prewarm_launches_the_exemplar_at_its_own_shape():
    """A bucket is a key, never a padding target: the prewarm job solves
    the exemplar at the exemplar's own shape, once alone and, for a
    bucket of several waves, stacked twice (the batched instance),
    however large the bucket's axes are."""
    snap = port_snapshot("own", 3, 4)
    host = bs.snapshot_to_host_inputs(snap)
    srv = _service(gather_window_s=0.001)
    srv._prewarm_exemplar = (host, BatchPolicy(), False)
    shapes = []
    device_solve = srv._device_solve

    def record(stacked, pol, gangs):
        shapes.append(stacked.cap.shape)
        return device_solve(stacked, pol, gangs)

    srv._device_solve = record
    srv.start()
    try:
        big = dict(_dims_of(host), N=4096, N1=4097, P=1024)
        assert srv._prewarm.boot_set([dict(big, BATCH=1),
                                      dict(big, BATCH=8)]) == 2
        assert _wait(lambda: srv._prewarm.ready(), timeout=30)
        assert srv._prewarm.errors == 0 and srv.prewarm_launches == 2
        n, r = host.cap.shape
        assert sorted(shapes) == [(1, n, r), (2, n, r)]
        assert srv.prewarm_s > 0
    finally:
        _stop(srv)


def test_daemon_boot_prewarm_sets_the_ready_gauge():
    sx = metrics.slipstream_metrics()
    srv = _service(prewarm=True, prewarm_nodes=40, prewarm_pods=256,
                   prewarm_batch=2).start()
    try:
        assert _wait(lambda: srv._prewarm.ready(), timeout=60)
        assert sx.prewarm_ready.value() == 1.0
        assert srv.prewarm_launches == 2 and srv._prewarm.errors == 0
    finally:
        _stop(srv)


# -- the batched launch's plain version --------------------------------------

_FAMILY_SEEDS = {"default": (800, 801, 802), "gang": (810, 811, 812),
                 "anti": (820, 821, 822), "int64": (830, 831),
                 "preempt": (840, 841)}


@pytest.mark.parametrize("family", sorted(_FAMILY_SEEDS))
def test_batch_plain_equals_each_waves_own_solve(family):
    """Seeded waves of one family, of different shapes, padded to the
    group's per-axis maximum: the batched plain version of each equals
    its own unpadded solve, pod for pod (padding changes no decision),
    and ``solve_commit_batch`` on the CPU is the plain version."""
    fractions = ((1.0, 1.0), (0.8, 0.7), (0.6, 1.2))
    snaps = []
    for seed, (fn, fp) in zip(_FAMILY_SEEDS[family], fractions):
        name = "default" if family in ("default", "gang") else family
        if family == "gang":
            wave, pol = chip_smoke._ext_wave(random.Random(seed),
                                             int(24 * fn), int(30 * fp),
                                             gangs=True)
            snaps.append(encode_snapshot(
                *wave, policy=dataclasses.replace(pol, w_spread=1)))
        elif name == "default":
            snaps.append(encode_snapshot(*chip_smoke._fuzz_wave(
                random.Random(seed), int(24 * fn), int(30 * fp), True)))
        else:
            snaps.append(chip_smoke._batch_wave(
                family, random.Random(seed), int(24 * fn), int(30 * fp)))
    hosts = [bs.snapshot_to_host_inputs(s) for s in snaps]
    assert len({(s.policy, str(h.cap.dtype)) for s, h in zip(snaps, hosts)}
               ) == 1
    target = _target_dims([_dims_of(h) for h in hosts])
    cis = [commit_solver.prepare(bs.ship_inputs(_pad_inputs(h, target), CPU),
                                 s.policy, s.has_gangs)
           for s, h in zip(snaps, hosts)]
    assert len({commit_solver.launch_key(ci) for ci in cis}) == 1
    calls = commit_solver.solve_commit_reference.calls
    out = commit_solver.solve_commit_batch(cis)
    assert commit_solver.solve_commit_reference.calls == calls + len(cis)
    for snap, host, (c, w) in zip(snaps, hosts, out):
        solo = commit_solver.solve_commit(commit_solver.prepare(
            bs.ship_inputs(host, CPU), snap.policy, snap.has_gangs))
        P = solo[0].shape[0]
        assert torch.equal(c[:P], solo[0]) and torch.equal(w[:P], solo[1])
        assert bool((c[P:] == -1).all())   # pad pods never place
    if family == "gang":
        assert any(s.has_gangs for s in snaps)


@pytest.mark.parametrize("family", sorted(_FAMILY_SEEDS))
def test_instance_read_off_host_inputs_equals_the_prepared_waves(family):
    """The daemon's prewarm names the kernel instance a wave would take
    from its host inputs alone (``instance_for``): the same name
    ``instance_of`` gives the prepared wave, alone and batched."""
    for seed in _FAMILY_SEEDS[family]:
        if family == "gang":
            # every extension: anchors, zones, label preferences
            wave, pol = chip_smoke._ext_wave(random.Random(seed), 24, 30,
                                             gangs=True, anti=1, aff=1,
                                             prefs=True)
            snap = encode_snapshot(*wave, policy=pol)
        else:
            snap = chip_smoke._batch_wave(family, random.Random(seed), 24,
                                          30)
        host = bs.snapshot_to_host_inputs(snap)
        ci = commit_solver.prepare(bs.ship_inputs(host, CPU), snap.policy,
                                   snap.has_gangs)
        for k in (1, 2):
            assert commit_solver.instance_for(
                host, snap.policy, snap.has_gangs, k) == \
                commit_solver.instance_of(ci, k)


def test_padding_keeps_the_off_list_slot_and_no_bands():
    snaps = [port_snapshot("pad-a", 3, 4), port_snapshot("pad-b", 5, 6)]
    hosts = [bs.snapshot_to_host_inputs(s) for s in snaps]
    hosts[0] = hosts[0]._replace(group_counts=np.array(
        [[1, 0, 2, 7]], np.int32))
    target = _target_dims([_dims_of(h) for h in hosts])
    assert target["N"] == 5 and target["N1"] == 6 and target["B"] == 0
    grown = _pad_inputs(hosts[0], target)
    assert grown.group_counts[0].tolist() == [1, 0, 2, 0, 0, 7]
    assert not grown.group_counts[1:].any()   # pad groups hold no peers
    assert not grown.node_extra_ok[3:].any()
    assert (grown.pod_host_idx[4:] == -2).all()
    # a lone wave is not padded at all
    alone = _pad_inputs(hosts[1], _target_dims([_dims_of(hosts[1])]))
    assert all(a is b for a, b in zip(alone, hosts[1]))


def test_state_stride_keeps_every_batched_wave_aligned():
    """A batched launch offsets each wave's packed state (the global
    layout's state and the gang checkpoint) by ``state_stride``: a
    multiple of 16 at least ``state_bytes``, which an odd node count
    and an odd group count leave 2 mod 4. The kernel and the wrapper
    take the same stride."""
    import pathlib
    import re

    for dims in ((1501, 2, 1, 1, 9, 0, 4), (6801, 2, 1, 1, 9, 0, 4),
                 (41, 2, 1, 2, 9, 8, 8), (1501, 3, 1, 1, 8, 0, 8)):
        sb = commit_solver.state_bytes(*dims)
        st = commit_solver.state_stride(*dims)
        assert st % 16 == 0 and sb <= st < sb + 16
    assert commit_solver.state_bytes(1501, 2, 1, 1, 9) % 4 == 2
    src = (pathlib.Path(commit_solver.__file__).parent / "csrc"
           / "commit_solve.cuh").read_text()
    assert re.search(r"state_stride\(.*?\)\s*\{\s*return \(state_bytes"
                     r"\(N, R, Wp, Wd, G, B, res_bytes\) \+ 15\) / 16 \* 16;",
                     src, re.S)
    offsets = src[src.index("if constexpr (kBatch) {"):]
    offsets = offsets[:offsets.index("chosen += b * ps;")]
    assert "state_stride(s.N, s.R, s.Wp, s.Wd, s.G, s.B, sizeof(Res))" \
        in offsets and "state_bytes" not in offsets
    assert "gstate += b * sb" in offsets and "ck += b * sb" in offsets


def test_batched_groups_of_odd_state_take_their_instance():
    """chip_smoke's phase 4d at the phase's node widths, 8 pods a wave:
    the groups padded to an odd node and group count (a gang group, int64
    with and without bands, int64 without bands, and a north_star group
    whose state lives in global memory) take the kernel instances and
    layouts the phase holds the card to, their state is not a multiple of
    4 bytes, and every padded wave's plain version equals its own
    unpadded solve."""
    b = chip_smoke._batch_phase(CPU, n_nodes=1_500, n_pods=8,
                                count_launches=False)
    chip_smoke._check_taken(b["taken"])
    assert b["max_abs_err"] == 0
    odd = [w for w in b["waves"] if w["group"].startswith("odd-")]
    assert len(odd) == 8
    assert all(w["padded_nodes"] % 2 == 1 and w["padded_groups"] % 2 == 1
               for w in odd)
    glob = [w for w in odd if w["group"] == "odd-global"]
    assert [w["nodes"] for w in glob] == [6801, 6596]


def test_solve_commit_batch_on_a_cuda_tensor_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert commit_solver.solve_commit_batch([]) == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverService()


# -- the binary --------------------------------------------------------------

def test_solverd_binary_serves_and_stops(tmp_path):
    """cmd/solverd.solverd_server in a thread: it answers a ping and a
    solve, serves /metrics and /healthz, stops on its event, and writes
    the --trace-device profile on the way out."""
    from chip_smoke import _free_port, _http_get

    port, mport = _free_port(), _free_port()
    ready, stop = threading.Event(), threading.Event()
    rc = {}
    argv = ["--port", str(port), "--metrics-port", str(mport), "--device",
            "cpu", "--gather_window", "0.001", "--trace-device",
            str(tmp_path / "prof")]
    t = threading.Thread(target=lambda: rc.update(
        v=port_solverd.solverd_server(argv, ready, stop)), daemon=True)
    t.start()
    try:
        assert ready.wait(30)
        cli = _solver(f"127.0.0.1:{port}")
        assert cli.ping()["v"] == protocol.PROTOCOL_VERSION
        snap = port_snapshot("bin", 4, 5)
        _same(cli.solve(snap), solve(snap))
        code, body = _http_get(f"http://127.0.0.1:{mport}/metrics")
        assert code == 200
        assert "solverd_coalesced_waves_total" in body
        code, body = _http_get(f"http://127.0.0.1:{mport}/healthz")
        assert code == 200 and '"healthy": true' in body
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive() and rc["v"] == 0
    assert (tmp_path / "prof" / "solverd_trace.json").stat().st_size > 0


def test_solverd_flags_mirror_the_reference(monkeypatch, capsys):
    from kubernetes_tpu.cmd import solverd as ref_solverd

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours = options(port_solverd.build_parser())
    theirs = options(ref_solverd.build_parser())
    assert ours - theirs == {"--device"}
    assert theirs - ours == set()
    # --mesh on fails on a one-device host, as the reference's does
    monkeypatch.setattr(port_mesh, "default_devices",
                        lambda: [torch.device("cpu")])
    assert port_solverd.solverd_server(["--mesh", "on", "--device",
                                        "cpu"]) == 1
    assert ">1 device" in capsys.readouterr().err
    assert port_solverd.solverd_server(["--max-batch", "x"]) == 2
    # with eight CPU shards the daemon starts with the mesh executor
    mesh_on_the_cpu(monkeypatch)
    stop = threading.Event()
    stop.set()
    assert port_solverd.solverd_server(
        ["--mesh", "on", "--device", "cpu", "--port", "0",
         "--mesh-min-nodes", "64", "--mesh-dispatch", "shard",
         "--mesh-probe", "all"], stop=stop) == 0
    assert ("mesh 8 node-shards x 1 pods (min 64 nodes, dispatch shard)"
            in capsys.readouterr().err)


# -- chip_smoke's new phases at a small size ---------------------------------

def test_chip_smoke_daemon_phases_run_on_the_cpu_at_a_small_size():
    """Phases 4d, 10 and 10b at 40 nodes on the plain version: batched ==
    plain == each wave's own solve; four clients coalesce, ride the delta
    wire and get the in-process decisions; the scheduler binary binds
    every pod through a solverd process with no fallback."""
    b = chip_smoke._batch_phase(CPU, n_nodes=40, n_pods=24, n_global=61,
                                count_launches=False)
    assert b["max_abs_err"] == 0 and len(b["waves"]) == 16
    assert b["groups"] == b["launch_keys"] == 8
    d = chip_smoke._daemon_phase(CPU, n_nodes=40, wave_size=32,
                                 count_launches=False)
    assert d["waves"] == 24 and max(d["group_sizes"]) >= 2
    assert d["delta_bytes_shipped"] < d["delta_bytes_full"]
    e = chip_smoke._daemon_binary_phase(CPU, n_nodes=40, n_pending=100)
    assert e["remote_waves"] >= 1 and e["local_launches"] == 0
    assert e["daemon_waves"] == e["remote_waves"]
