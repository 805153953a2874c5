"""The port's flight recorder (kubernetes_tpu_torch/util/metrics.py) against
the JAX package's, on the CPU, and the scheduler binary's /debug/vars and
/debug/trace.

The series ring (bounded, evicting the oldest, counted), the recorder's
sampling of counters, gauges and histograms with a ``<name>:rate`` series
per counter (a reset clamps to 0), the ``vars_payload`` cursor contract
and its keys equal to the reference's, lazy idempotent arming and
disarming, and the port's ``scheduler_server`` with ``--pipeline --trace
--flightrec`` on the CPU against the JAX package's apiserver (served in
this process): its /debug/vars holds ``scheduler_pipeline_waves_total``
and its rate, and its /debug/trace holds the waves' spans. Every test
disarms the recorder and disables tracing in a ``finally``: a sampler
thread left running would tax every later test in its worker.
"""

import json
import threading
import time

import pytest

from chip_smoke import _free_port, _http_get, _wait_http
from kubernetes_tpu.cmd.apiserver import apiserver_server
from kubernetes_tpu.util import metrics as ref_metrics
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.http import HTTPTransport
from kubernetes_tpu_torch.cmd import scheduler as port_cmd
from kubernetes_tpu_torch.util import metrics as metrics_pkg
from kubernetes_tpu_torch.util import tracing
from kubernetes_tpu_torch.util.metrics import (FlightRecorder, Registry,
                                               _SeriesRing)


@pytest.fixture(autouse=True)
def _disarm():
    try:
        yield
    finally:
        metrics_pkg.flightrec_disarm()
        tracing.drain()
        tracing.disable()


def _recorder(reg, **kw):
    fr = FlightRecorder(period_s=3600, **kw)
    fr._registries = [reg]   # isolate from the process default registry
    return fr


class TestSeriesRing:
    def test_bound_and_evict_counted(self):
        r = _SeriesRing("gauge", 4)
        for i in range(10):
            r.put(i * 100, float(i))
        assert [p[1] for p in r.since(0)] == [6.0, 7.0, 8.0, 9.0]
        assert r.evicted == 6

    def test_cursor_drain_semantics(self):
        r = _SeriesRing("gauge", 8)
        for i in range(5):
            r.put((i + 1) * 100, float(i))
        assert len(r.since(0)) == len(r.since(0)) == 5
        cursor = r.since(0)[-1][0]
        assert r.since(cursor) == []
        r.put(999, 42.0)
        assert [p[1] for p in r.since(cursor)] == [42.0]

    def test_same_samples_as_the_reference_ring(self):
        ours, ref = _SeriesRing("counter", 16), ref_metrics._SeriesRing(
            "counter", 16)
        for i in range(40):
            ours.put(i, float(i * i))
            ref.put(i, float(i * i))
        for cursor in (0, 23, 30, 38, 39):
            assert ours.since(cursor) == ref.since(cursor)
        assert ours.evicted == ref.evicted == 24


class TestFlightRecorder:
    def test_counter_rate_series(self):
        reg = Registry()
        c = reg.counter("work_total", "w")
        fr = _recorder(reg, service="t")
        c.inc(by=10)
        fr.sample_now()
        c.inc(by=25)
        time.sleep(0.02)
        fr.sample_now()
        raw = fr._rings["work_total"].since(0)
        assert [p[1] for p in raw] == [10.0, 35.0]
        rates = fr._rings["work_total:rate"].since(0)
        assert len(rates) == 1
        dt_s = (raw[1][0] - raw[0][0]) / 1e9
        assert rates[0][1] == pytest.approx(25.0 / dt_s, rel=1e-6)

    def test_counter_reset_clamps_rate_to_zero(self):
        reg = Registry()
        c = reg.counter("x_total", "x")
        fr = _recorder(reg)
        c.inc(by=100)
        fr.sample_now()
        with c._lock:
            c._values[()] = 5.0  # a restarted process's counter
        time.sleep(0.002)
        fr.sample_now()
        assert fr._rings["x_total:rate"].since(0)[-1][1] == 0.0

    def test_labelled_series_and_histograms_like_the_reference(self):
        """The same metrics in both packages' registries sample to the
        same series names, types and values."""
        def fill(reg):
            reg.counter("inval_total", "i", ("reason",)).inc("store_delta")
            reg.gauge("depth", "d").set(3)
            h = reg.histogram("lat_s", "l", buckets=(0.1, 1.0))
            for v in (0.05, 0.5, 5.0):
                h.observe(v)

        ours, ref = Registry(), ref_metrics.Registry()
        fill(ours)
        fill(ref)
        assert ours.sample() == ref.sample()
        fr = _recorder(ours)
        fr.sample_now()
        assert fr._rings['inval_total{reason="store_delta"}'].since(0)[-1][1] \
            == 1.0
        assert fr._rings['lat_s_bucket{le="+Inf"}'].since(0)[-1][1] == 3.0
        assert fr._rings["lat_s_count"].since(0)[-1][1] == 3.0
        assert 'lat_s_bucket{le="1"}:rate' not in fr._rings

    def test_process_builtin_series(self):
        fr = _recorder(Registry())
        fr.sample_now()
        assert fr._rings["process_resident_bytes"].since(0)[-1][1] > 1e6
        assert "process_cpu_seconds_total" in fr._rings
        assert "tracing_spans_dropped" not in fr._rings or \
            fr._rings["tracing_spans_dropped"].since(0)[-1][1] >= 0
        tracing.enable("test", capacity=8)
        for i in range(20):
            tracing.record("s", i, i + 1)
        fr.sample_now()
        assert fr._rings["tracing_spans_dropped"].since(0)[-1][1] == 12.0

    def test_vars_payload_incremental_by_since(self):
        reg = Registry()
        g = reg.gauge("depth", "d")
        fr = _recorder(reg, service="svc")
        g.set(1)
        fr.sample_now()
        p1 = fr.vars_payload(0)
        assert p1["armed"] and p1["service"] == "svc"
        cursor = p1["series"]["depth"]["samples"][-1][0]
        g.set(2)
        fr.sample_now()
        p2 = fr.vars_payload(cursor)
        assert [s[1] for s in p2["series"]["depth"]["samples"]] == [2.0]
        assert fr.vars_payload(p2["t_ns"] + 10**12)["series"] == {}
        ref_fr = ref_metrics.FlightRecorder(service="svc", period_s=3600)
        ref_fr._registries = [ref_metrics.Registry()]
        ref_fr.sample_now()
        assert set(p2) == set(ref_fr.vars_payload(0))

    def test_eviction_is_bounded_and_counted_in_the_payload(self):
        reg = Registry()
        g = reg.gauge("depth", "d")
        fr = _recorder(reg, capacity=4)
        for i in range(10):
            g.set(i)
            fr.sample_now()
        p = fr.vars_payload(0)
        assert [s[1] for s in p["series"]["depth"]["samples"]] == \
            [6.0, 7.0, 8.0, 9.0]
        assert p["evicted"] >= 6


class TestArming:
    def test_disarmed_process_pays_nothing(self):
        metrics_pkg.flightrec_disarm()
        assert not metrics_pkg.flightrec_armed()
        assert metrics_pkg.flightrec() is None
        payload = metrics_pkg.flightrec_vars(0)
        assert payload["armed"] is False and payload["series"] == {}
        assert metrics_pkg.flightrec_sample_now() == 0
        assert not metrics_pkg.flightrec_armed()

    def test_arm_is_lazy_idempotent_and_disarmable(self):
        fr = metrics_pkg.flightrec_arm("one", period_s=3600)
        try:
            assert metrics_pkg.flightrec_arm("two", period_s=3600) is fr
            assert fr.service == "one"
            assert metrics_pkg.flightrec_armed()
            assert metrics_pkg.flightrec_vars(0)["series"]
            assert metrics_pkg.flightrec_sample_now() > 0
            extra = Registry()
            extra.gauge("extra_depth", "e").set(7)
            metrics_pkg.flightrec_watch(extra)
            metrics_pkg.flightrec_sample_now()
            assert metrics_pkg.flightrec_vars(0)["series"]["extra_depth"][
                "samples"][-1][1] == 7.0
            assert fr._thread.is_alive()
        finally:
            metrics_pkg.flightrec_disarm()
        assert not metrics_pkg.flightrec_armed()
        assert not fr._thread.is_alive()


# -- the binary's /debug/vars and /debug/trace -------------------------------

def _node(i):
    return port_api.Node(
        metadata=port_api.ObjectMeta(name=f"n{i}"),
        spec=port_api.NodeSpec(capacity={"cpu": Quantity("4"),
                                         "memory": Quantity("8Gi")}))


def _pod(i):
    return port_api.Pod(
        metadata=port_api.ObjectMeta(name=f"p{i:03d}", namespace="default",
                                     uid=f"uid-p{i:03d}"),
        spec=port_api.PodSpec(containers=[port_api.Container(
            name="c", image="i",
            resources=port_api.ResourceRequirements(limits={
                "cpu": Quantity("100m"), "memory": Quantity("64Mi")}))]))


def test_binary_debug_vars_and_trace():
    """``--algorithm tpu-batch --pipeline --trace --flightrec --device
    cpu`` in a thread against the JAX package's apiserver: every pod
    binds, the loop ran pipelined, /debug/vars?since=0 holds the pipeline
    waves series and its rate, and /debug/trace holds each wave's drain,
    prepare, encode, solve and commit spans under one trace id."""
    aport, mport = _free_port(), _free_port()
    a_ready, a_stop = threading.Event(), threading.Event()
    api_thread = threading.Thread(
        target=apiserver_server, args=(["--port", str(aport)],),
        kwargs={"ready": a_ready, "stop": a_stop}, daemon=True)
    api_thread.start()
    s_ready, s_stop = threading.Event(), threading.Event()
    result = {}
    sched_thread = None
    try:
        assert a_ready.wait(30)
        url = f"http://127.0.0.1:{aport}"
        client = Client(HTTPTransport(url))
        for i in range(4):
            client.nodes().create(_node(i))
        argv = ["--master", url, "--algorithm", "tpu-batch", "--pipeline",
                "--trace", "--flightrec", "--flightrec-period", "0.05",
                "--device", "cpu", "--wave-period", "0.02",
                "--metrics-port", str(mport)]
        sched_thread = threading.Thread(
            target=lambda: result.update(rc=port_cmd.scheduler_server(
                argv, s_ready, s_stop)), daemon=True)
        sched_thread.start()
        assert s_ready.wait(30)
        murl = f"http://127.0.0.1:{mport}"
        _wait_http(murl + "/healthz/ping", None, "the binary", 30)
        for i in range(40):
            client.pods().create(_pod(i))
        deadline = time.monotonic() + 30
        while not all(p.spec.host for p in client.pods().list().items):
            assert time.monotonic() < deadline, "pods never bound"
            time.sleep(0.05)
        time.sleep(0.2)   # a few more samples after the last wave
        code, body = _http_get(murl + "/debug/vars?since=0")
        fr = json.loads(body)
        assert code == 200 and fr["armed"] and fr["service"] == "scheduler"
        waves = fr["series"]["scheduler_pipeline_waves_total"]["samples"]
        assert waves[-1][1] >= 1
        assert "scheduler_pipeline_waves_total:rate" in fr["series"]
        code, body = _http_get(murl + "/debug/trace?peek=1")
        shard = json.loads(body)
        assert code == 200 and shard["service"] == "scheduler"
        spans = shard["spans"]
        by_trace: dict = {}
        for s in spans:
            by_trace.setdefault(s["tid"], set()).add(s["name"])
        stages = {"wave.drain", "wave.prepare", "wave.encode", "wave.solve",
                  "wave.commit"}
        assert any(stages <= names for names in by_trace.values()), by_trace
        # the peek left the spans for the draining pull
        assert len(json.loads(_http_get(murl + "/debug/trace")[1])[
            "spans"]) >= len(spans)
    finally:
        s_stop.set()
        if sched_thread is not None:
            sched_thread.join(timeout=30)
        a_stop.set()
        api_thread.join(timeout=10)
    assert result.get("rc") == 0
    # the server turned off what it turned on
    assert not metrics_pkg.flightrec_armed()
    assert not tracing.enabled()
