"""The port's kube-trace (kubernetes_tpu_torch/util/tracing.py) against the
JAX package's, on the CPU.

Span nesting and parenting, the ring buffer's never-block and
evict-oldest contract with its counted loss, the wire form read by either
package's ``parse``, the Chrome-trace export equal to the reference's for
the same shards, the disabled path's <1% overhead guard against the
port's own encode, the wave path's stage spans (``encode.*`` in
``encode_snapshot``, ``solve.*`` in ``solve`` and the prolog) with their
mirror into ``torch.profiler``'s trace, and the ``X-KTPU-Trace`` header of the port's
``HTTPTransport`` joining the JAX package's apiserver (served in this
process with the reference's tracing on) to the port's trace. Every test
leaves both packages' tracing disabled.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from chip_smoke import _free_port
from kubernetes_tpu.cmd.apiserver import apiserver_server
from kubernetes_tpu.util import tracing as ref_tracing
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.http import HTTPTransport
from kubernetes_tpu_torch.models import batch_solver
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.util import tracing


@pytest.fixture(autouse=True)
def _tracing_off_after():
    """Tracing state is process-global in both packages: every test
    leaves it the way entry points start, disabled with drained rings."""
    try:
        yield
    finally:
        for t in (tracing, ref_tracing):
            t.drain()
            t.disable()


def fresh(capacity=4096):
    tracing.enable("test", capacity=capacity)
    tracing.drain()


def mk_node(name):
    return port_api.Node(
        metadata=port_api.ObjectMeta(name=name),
        spec=port_api.NodeSpec(capacity={"cpu": Quantity("8"),
                                         "memory": Quantity("16Gi")}))


def mk_pod(name, host=""):
    return port_api.Pod(
        metadata=port_api.ObjectMeta(name=name, namespace="default",
                                     uid=f"uid-{name}",
                                     labels={"app": "web"}),
        spec=port_api.PodSpec(containers=[port_api.Container(
            name="c", image="i",
            resources=port_api.ResourceRequirements(limits={
                "cpu": Quantity("500m"), "memory": Quantity("512Mi")}))]),
        status=port_api.PodStatus(host=host))


# -- spans: nesting and parenting --------------------------------------------

class TestSpans:
    def test_nesting_and_ordering(self):
        fresh()
        with tracing.span("outer", parent=None, wave=7) as outer:
            with tracing.span("inner") as inner:
                time.sleep(0.001)
        assert inner.ctx[0] == outer.ctx[0]
        spans = tracing.drain()["spans"]
        assert [s["name"] for s in spans] == ["inner", "outer"]
        i, o = spans
        assert i["tid"] == o["tid"]
        assert i["psid"] == o["sid"]
        assert o["psid"] == ""
        assert o["attrs"] == {"wave": 7}
        assert i["t0"] >= o["t0"]
        assert i["t0"] + i["dur"] <= o["t0"] + o["dur"]

    def test_disabled_is_nop_and_records_nothing(self):
        fresh()
        tracing.disable()
        s = tracing.span("x")
        assert s is tracing.NOP
        with s:
            assert tracing.current() is None
        tracing.record("y", 0, 10)
        assert tracing.new_ctx() is None
        assert tracing.wire() == ""
        assert tracing.start("z") is tracing.NOP
        tracing.enable("test")
        assert tracing.drain()["spans"] == []

    def test_child_span_outside_any_trace_is_nop(self):
        fresh()
        assert tracing.child_span("store.create") is tracing.NOP
        with tracing.span("req"):
            with tracing.child_span("store.create") as c:
                assert c is not tracing.NOP
        names = [s["name"] for s in tracing.drain()["spans"]]
        assert names == ["store.create", "req"]

    def test_exception_tags_span_and_propagates(self):
        fresh()
        with pytest.raises(ValueError):
            with tracing.span("boom"):
                raise ValueError("x")
        (sp,) = tracing.drain()["spans"]
        assert sp["attrs"]["error"] == "ValueError"

    def test_explicit_parent_crosses_threads(self):
        fresh()
        ctx = tracing.new_ctx()
        done = threading.Event()

        def worker():
            with tracing.span("stage", parent=ctx):
                pass
            done.set()

        threading.Thread(target=worker, name="tpu-batch-solve_0").start()
        assert done.wait(5)
        (sp,) = tracing.drain()["spans"]
        assert sp["tid"] == ctx[0] and sp["psid"] == ctx[1]
        assert sp["thr"] == "tpu-batch-solve_0"

    def test_start_finish_handle_does_not_install_ambient(self):
        fresh()
        h = tracing.start("wave", pods=3)
        assert tracing.current() is None
        h.set(bound=3)
        h.finish(committed=True)
        (sp,) = tracing.drain()["spans"]
        assert sp["name"] == "wave"
        assert sp["attrs"] == {"pods": 3, "bound": 3, "committed": True}

    def test_record_retroactive_span(self):
        fresh()
        ctx = tracing.new_ctx()
        tracing.record("wave.drain", 100, 250, parent=ctx, pods=4)
        (sp,) = tracing.drain()["spans"]
        assert (sp["tid"], sp["psid"]) == ctx
        assert sp["t0"] == 100 and sp["dur"] == 150


# -- the ring ------------------------------------------------------------------

class TestRing:
    def test_bounded_eviction_counts_dropped_never_blocks(self):
        fresh(capacity=64)
        for i in range(200):
            tracing.record("s", i, i + 1, idx=i)
        assert tracing.loss_peek() == 200 - 64   # visible before a drain
        shard = tracing.drain()
        assert len(shard["spans"]) == 64
        assert shard["dropped"] == 200 - 64
        assert shard["written"] == 200
        assert [s["attrs"]["idx"] for s in shard["spans"]] == \
            list(range(136, 200))
        assert tracing.loss_peek() == 0

    def test_drain_before_enable_is_empty_not_an_error(self):
        saved = tracing._state.ring
        try:
            tracing.disable()
            tracing._state.ring = None
            assert tracing.loss_peek() is None
            shard = tracing.drain()
            assert shard["spans"] == []
            assert shard["written"] == 0 and shard["dropped"] == 0
        finally:
            tracing._state.ring = saved

    def test_drain_returns_each_span_once_and_peek_keeps_the_cursor(self):
        fresh(capacity=64)
        tracing.record("a", 0, 1)
        assert len(tracing.drain(reset=False)["spans"]) == 1
        assert len(tracing.drain()["spans"]) == 1
        assert tracing.drain()["spans"] == []
        tracing.record("b", 1, 2)
        shard = tracing.drain()
        assert [s["name"] for s in shard["spans"]] == ["b"]
        assert shard["dropped"] == 0

    def test_concurrent_writers_never_error(self):
        fresh(capacity=128)
        stop = threading.Event()
        errs = []

        def writer():
            try:
                while not stop.is_set():
                    with tracing.span("w"):
                        pass
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=writer) for _ in range(4)]
        for t in threads:
            t.start()
        for _ in range(20):
            tracing.drain()
            time.sleep(0.001)
        stop.set()
        for t in threads:
            t.join(5)
        assert not errs


# -- the wire form, read by either package -----------------------------------

class TestWireForm:
    def test_each_package_parses_the_others_header(self):
        fresh()
        ref_tracing.enable("ref-test")
        assert tracing.HEADER == ref_tracing.HEADER == "X-KTPU-Trace"
        with tracing.span("port") as sp:
            w = tracing.wire()
        assert w and ref_tracing.parse(w) == tracing.parse(w) == sp.ctx
        with ref_tracing.span("ref") as rsp:
            rw = ref_tracing.wire()
        assert tracing.parse(rw) == ref_tracing.parse(rw) == rsp.ctx
        # a span parented on the other package's context joins its trace
        with tracing.span("child", parent=tracing.parse(rw)) as c:
            pass
        assert c.ctx[0] == rsp.ctx[0]

    @pytest.mark.parametrize("junk", [
        None, "", "noseparator", "-", "a-", "-b", 42, b"x-y",
        "t" * 65 + "-s", "t-" + "s" * 65])
    def test_parse_tolerates_junk_as_the_reference_does(self, junk):
        assert tracing.parse(junk) is None
        assert ref_tracing.parse(junk) is None


# -- the wave path's stage spans --------------------------------------------

STAGES = {"encode.nodes", "encode.pending", "encode.residents",
          "solve.host_inputs", "solve.ship", "solve.prolog",
          "solve.commit", "solve.readback"}


def _wave_objects(n_nodes=6, per_node=2, n_pending=9):
    nodes = [mk_node(f"st-n{i}") for i in range(n_nodes)]
    residents = [mk_pod(f"st-r{i}-{k}", host=f"st-n{i}")
                 for i in range(n_nodes) for k in range(per_node)]
    pending = [mk_pod(f"st-p{j}") for j in range(n_pending)]
    return nodes, residents, pending


def _wave(nodes, residents, pending):
    snap = encode_snapshot(nodes, residents, pending, [])
    chosen, scores = batch_solver.solve(snap, device="cpu")
    return snap, chosen, scores


class TestWavePathSpans:
    def test_encode_and_solve_record_the_seven_stages(self):
        objs = _wave_objects()
        off_snap, off_chosen, off_scores = _wave(*objs)
        fresh()
        with tracing.span("wave") as wave:
            snap, chosen, scores = _wave(*objs)
        spans = tracing.drain()["spans"]
        assert {s["name"] for s in spans} == STAGES | {"wave"}
        counts = {"nodes": len(objs[0])}
        pods = {"encode.residents": len(objs[1]),
                "encode.pending": len(objs[2])}
        # the residents' scatter also says which optional walks ran (no
        # services, host ports or PDs here) and how many rows it scattered
        walks = {"labels": 0, "services": 0, "ports": 0, "volumes": 0,
                 "rows": 2 * len(objs[1])}
        # the commit names what ran: on the CPU, the plain version
        commit = {"instance": "plain"}
        scatters = [s for s in spans if "rows" in s["attrs"]]
        assert [s["name"] for s in scatters] == ["encode.residents"]
        for s in spans:
            if s["name"] == "encode.nodes":
                assert s["attrs"] == counts
            elif s in scatters:
                assert s["attrs"] == {"pods": pods[s["name"]], **walks}
            elif s["name"] in pods:
                assert s["attrs"] == {"pods": pods[s["name"]]}
            elif s["name"] == "solve.commit":
                assert s["attrs"] == commit
            elif s["name"] != "wave":
                assert s["attrs"] == {}
            if s["name"] != "wave":
                # the caller's span is the ambient parent of every stage
                assert s["psid"] == wave.ctx[1] and s["tid"] == wave.ctx[0]
        # the stages of one encode do not overlap, and sit in its order
        enc = sorted((s for s in spans if s["name"].startswith("encode.")),
                     key=lambda s: s["t0"])
        for a, b in zip(enc, enc[1:]):
            assert a["t0"] + a["dur"] <= b["t0"]
        assert [s["name"] for s in enc][:3] == [
            "encode.nodes", "encode.pending", "encode.residents"]
        # tracing changes nothing the wave computes
        assert np.array_equal(chosen, off_chosen)
        assert np.array_equal(scores, off_scores)
        for f in dataclasses.fields(snap):
            a, b = getattr(snap, f.name), getattr(off_snap, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name

    def test_tracing_off_allocates_no_span_and_records_nothing(
            self, monkeypatch):
        objs = _wave_objects()
        fresh()
        before = tracing.drain()["written"]
        tracing.disable()

        def no_span(*_a, **_k):
            raise AssertionError("a span was built with tracing off")
        monkeypatch.setattr(tracing, "_Span", no_span)
        monkeypatch.setattr(tracing, "_mirror", no_span)
        _wave(*objs)
        tracing.enable("test", capacity=4096)   # the ring fresh() made
        shard = tracing.drain()
        assert shard["spans"] == [] and shard["written"] == before

    def test_under_the_profiler_each_stage_is_a_ktpu_annotation(
            self, tmp_path):
        from torch.profiler import ProfilerActivity, profile, record_function
        objs = _wave_objects()
        fresh()
        assert tracing._mirror("x") is None   # no profiler: no mirror
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("caller"):
                _wave(*objs)
        path = tmp_path / "prof.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        (caller,) = [e for e in events if e["name"] == "caller"]
        mirrored = [e for e in events
                    if e["name"].startswith(tracing.PROFILER_PREFIX)]
        assert {e["name"] for e in mirrored} == {
            tracing.PROFILER_PREFIX + n for n in STAGES}
        lo, hi = caller["ts"], caller["ts"] + caller["dur"]
        for e in mirrored:
            assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e["name"]
        # one mirror for each span the ring recorded
        ring = tracing.drain()["spans"]
        assert len(ring) == len(mirrored)
        assert sorted(s["name"] for s in ring) == sorted(
            e["name"][len(tracing.PROFILER_PREFIX):] for e in mirrored)
        # the profiler stopped: spans record without a mirror again
        with tracing.span("after") as sp:
            assert sp._rf is None


# -- the Chrome-trace export -------------------------------------------------

class TestChromeExport:
    def test_export_equals_the_references_for_the_same_shards(self, tmp_path):
        fresh()
        with tracing.span("wave", pods=2):
            with tracing.span("encode"):
                pass
        shard_a = tracing.drain()
        shard_b = {"service": "apiserver", "pid": 999, "written": 1,
                   "dropped": 3, "spans": [
                       {"name": "http.post", "tid": "t2", "sid": "s2",
                        "psid": "p2", "t0": 5_000_000, "dur": 1_000_000,
                        "thr": "worker-0", "attrs": {"code": 201}}]}
        want = ref_tracing.chrome_trace([shard_a, shard_b])
        assert tracing.chrome_trace([shard_a, shard_b]) == want
        path = tracing.dump_chrome([shard_a, shard_b],
                                   str(tmp_path / "merged_trace.json"))
        with open(path) as fh:
            doc = json.load(fh)
        assert doc == json.loads(json.dumps(want))
        x = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert len(x) == 3
        assert {e["args"]["name"] for e in doc["traceEvents"]
                if e["name"] == "process_name"} >= {"test", "apiserver"}
        sd = next(e for e in x if e["name"] == "http.post")
        assert sd["dur"] == pytest.approx(1000.0) and sd["pid"] == 999


# -- the overhead guard --------------------------------------------------------

class TestOverheadGuard:
    def test_disabled_tracing_under_1pct_of_stage_loop(self):
        """The disabled path, costed against the port's cheapest real
        stage (one 128-node/256-pod encode): one wave's worth of disabled
        call sites, the stage spans of that wave's encode and solve
        among them, must cost <1% of it. Both sides are timed min-of-N so
        a loaded machine cannot fail the comparison on noise alone."""
        N, P, E = 128, 256, 0
        nodes = [mk_node(f"ov-n{i}") for i in range(N)]
        pending = [mk_pod(f"ov-p{j}") for j in range(P)]
        # the stage spans costed below are the ones this wave opens
        fresh()
        _wave(nodes, [], pending)
        opened = sorted((s["name"], tuple(s["attrs"].items()))
                        for s in tracing.drain()["spans"])
        assert opened == sorted(
            [("encode.nodes", (("nodes", N),))] * 4
            + [("encode.pending", (("pods", P),))] * 2
            + [("encode.residents", (("pods", E),)),
               ("encode.residents", (("pods", E), ("labels", 0),
                                     ("services", 0), ("ports", 0),
                                     ("volumes", 0), ("rows", 0)))]
            + [(n, ()) for n in ("solve.host_inputs", "solve.ship",
                                 "solve.prolog", "solve.readback")]
            + [("solve.commit", (("instance", "plain"),))])
        tracing.disable()
        encode_snapshot(nodes, [], pending, [])  # warm the path

        def one_encode():
            t0 = time.perf_counter()
            encode_snapshot(nodes, [], pending, [])
            return time.perf_counter() - t0

        stage_s = min(one_encode() for _ in range(5))

        def noop_waves(n=10_000):
            t0 = time.perf_counter()
            for _ in range(n):
                with tracing.span("wave.encode"):
                    pass
                with tracing.span("wave.solve"):
                    pass
                with tracing.span("wave.commit"):
                    pass
                with tracing.child_span("store.create"):
                    pass
                # the stage spans this wave's encode_snapshot and solve
                # open (checked against the program below)
                with tracing.span("encode.nodes", nodes=N):
                    pass
                with tracing.span("encode.pending", pods=P):
                    pass
                with tracing.span("encode.residents", pods=E):
                    pass
                with tracing.span("encode.nodes", nodes=N):
                    pass
                with tracing.span("encode.pending", pods=P):
                    pass
                with tracing.span("encode.nodes", nodes=N):
                    pass
                with tracing.span("encode.residents", pods=E) as sp:
                    sp.set(labels=0, services=0, ports=0, volumes=0, rows=0)
                with tracing.span("encode.nodes", nodes=N):
                    pass
                with tracing.span("solve.host_inputs"):
                    pass
                with tracing.span("solve.ship"):
                    pass
                with tracing.span("solve.prolog"):
                    pass
                with tracing.span("solve.commit", instance="plain"):
                    pass
                with tracing.span("solve.readback"):
                    pass
                tracing.new_ctx()
                tracing.record("wave.drain", 0, 1)
                tracing.record("wave.prepare", 0, 1)
                tracing.current()
                tracing.current()
                tracing.wire()
            return (time.perf_counter() - t0) / n

        per_wave_s = min(noop_waves() for _ in range(5))
        assert per_wave_s < 0.01 * stage_s, (
            f"disabled tracing {per_wave_s * 1e6:.2f}us/wave vs stage "
            f"{stage_s * 1e3:.2f}ms — over the 1% budget")


# -- the header over HTTP, into the JAX package's apiserver ------------------

def test_port_request_joins_the_reference_apiservers_trace():
    """The port's HTTPTransport, inside a port span, creates and binds a
    pod on the JAX package's apiserver (served in this process, the
    reference's tracing on): the apiserver's handler and store spans carry
    the port's trace id and parent into it; untraced requests add none."""
    port = _free_port()
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=apiserver_server,
                         args=(["--port", str(port), "--trace"],),
                         kwargs={"ready": ready, "stop": stop}, daemon=True)
    t.start()
    try:
        assert ready.wait(30)
        fresh()
        client = Client(HTTPTransport(f"http://127.0.0.1:{port}"))
        client.nodes().create(mk_node("trace-n0"))   # outside any span
        ref_tracing.drain()
        with tracing.span("test.bind") as sp:
            client.pods("default").create(mk_pod("trace-p0"))
            client.pods("default").bind(port_api.Binding(
                metadata=port_api.ObjectMeta(name="trace-p0",
                                             namespace="default"),
                pod_name="trace-p0", host="trace-n0"))
        client.nodes().create(mk_node("trace-n1"))   # untraced again
        tid = sp.ctx[0]
        spans = ref_tracing.drain()["spans"]
        remote = [s for s in spans if s["tid"] == tid]
        names = {s["name"] for s in remote}
        assert "http.post" in names
        assert "store.create" in names
        assert all(s["psid"] for s in remote)
        # the untraced creates opened no trace of the port's
        assert all(s["tid"] == tid for s in spans
                   if s["name"] == "http.post")
        # the client-side span stayed in the port's ring
        assert "test.bind" in {s["name"] for s in tracing.drain()["spans"]}
    finally:
        stop.set()
        t.join(timeout=10)
