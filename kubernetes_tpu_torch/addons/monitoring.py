"""Cluster monitoring addon — the heapster analog, grown into the
kube-flightrec aggregator.

Port of ``kubernetes_tpu/addons/monitoring.py``, whole.

ref: cluster/addons/cluster-monitoring/ (heapster + influxdb/grafana):
the reference runs an aggregator that discovers nodes through the API,
scrapes every kubelet's cAdvisor stats, and exposes cluster-level
resource metrics. Same shape here:

- node discovery via the node list-watch cache (the component pattern);
- per-node scrape of the kubelet read-only server: /spec (MachineInfo)
  and /stats (node ContainerStats), over a pluggable fetch seam — HTTP
  against ``<address>:<kubelet-port>`` by default, injectable for the
  in-process cluster harness;
- aggregation into cluster totals (cores, memory capacity, cpu seconds,
  memory usage, pods per node via the pod cache) re-exposed as
  Prometheus gauges on its own /metrics endpoint plus a JSON summary at
  /api/v1/model (heapster's model-API path).

kube-flightrec (this file's second half) is the control-plane analog:
``FlightAggregator`` discovers every control-plane process — including
each SO_REUSEPORT apiserver worker pid behind one shared port, using the
drain-until-all-pids-answer pattern kube-trace collection established —
pulls each process's ``GET /debug/vars?since=<ns>`` metric time-series
shard incrementally, merges shards on the shared CLOCK_MONOTONIC axis,
evaluates declarative ``SLORule``s live (``SLOWatchdog`` records alarm
TRANSITIONS with the offending samples, deduplicated while a rule stays
in violation), and assembles the ``timeline``/``alarms`` record sections
the CHURN_MP r11+ contract requires (docs/design/observability.md).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import Reflector, Store
from kubernetes_tpu_torch.util import metrics as metrics_pkg

__all__ = ["Monitoring", "http_kubelet_fetcher",
           "SLORule", "SLOWatchdog", "FlightAggregator",
           "default_churn_rules"]


def http_kubelet_fetcher(kubelet_port: int = 10250,
                         timeout: float = 2.0) -> Callable:
    """Default scrape seam: GET the kubelet read-only server over HTTP."""
    def fetch(node: api.Node, path: str) -> Optional[dict]:
        host = node.metadata.name
        for addr in node.status.addresses:
            if addr.address:
                host = addr.address
                break
        try:
            with urllib.request.urlopen(
                    f"http://{host}:{kubelet_port}{path}",
                    timeout=timeout) as r:
                return json.loads(r.read())
        except (OSError, ValueError):
            return None
    return fetch


class Monitoring:
    """Scrape kubelets, aggregate, expose. One resync per period."""

    def __init__(self, client, fetch: Optional[Callable] = None,
                 period_s: float = 5.0, host: str = "127.0.0.1",
                 port: int = 0):
        self.client = client
        self.fetch = fetch or http_kubelet_fetcher()
        self.period_s = period_s
        self.nodes = Store()
        self.pods = Store()
        self._reflectors = [
            Reflector(client.nodes().list_watch(), self.nodes,
                      name="monitoring-nodes"),
            Reflector(client.pods(api.NamespaceAll).list_watch(
                field_selector="spec.host!="), self.pods,
                name="monitoring-pods"),
        ]
        self.registry = metrics_pkg.Registry()
        self._g_nodes = self.registry.gauge(
            "cluster_nodes", "nodes known to the monitoring addon")
        self._g_ready = self.registry.gauge(
            "cluster_nodes_scraped", "nodes whose kubelet answered")
        self._g_cores = self.registry.gauge(
            "cluster_machine_cores", "sum of node cores")
        self._g_mem_cap = self.registry.gauge(
            "cluster_machine_memory_bytes", "sum of node memory capacity")
        self._g_cpu = self.registry.gauge(
            "cluster_cpu_usage_core_seconds", "sum of node cpu seconds")
        self._g_mem = self.registry.gauge(
            "cluster_memory_usage_bytes", "sum of node memory usage")
        self._g_pods = self.registry.gauge(
            "cluster_pods_assigned", "pods bound to nodes")
        self.model: Dict[str, dict] = {"nodes": {}, "cluster": {}}
        # optional kube-flightrec aggregator (cmd/monitoring wires it);
        # the handler then serves /api/v1/timeline + /api/v1/alarms
        self.flight: Optional["FlightAggregator"] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.addon = self  # type: ignore[attr-defined]
        self._threads = []

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "Monitoring":
        for r in self._reflectors:
            r.run()
        self._threads = [
            threading.Thread(target=self._scrape_loop, daemon=True,
                             name="monitoring-scrape"),
            threading.Thread(target=self._srv.serve_forever, daemon=True,
                             name="monitoring-http"),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()
        self._srv.shutdown()
        self._srv.server_close()

    # -- scraping -----------------------------------------------------------
    def scrape_once(self) -> dict:
        nodes = self.nodes.list()
        pods_per_node: Dict[str, int] = {}
        for p in self.pods.list():
            host = p.spec.host or p.status.host
            if host:
                pods_per_node[host] = pods_per_node.get(host, 0) + 1
        per_node = {}
        totals = {"cores": 0, "memory_capacity": 0,
                  "cpu_usage_core_seconds": 0.0, "memory_usage": 0,
                  "scraped": 0}
        # scrape concurrently (as heapster does): a few dead kubelets at a
        # 2s timeout each must not stretch one pass past the scrape period
        with ThreadPoolExecutor(max_workers=min(16, max(1, len(nodes)))) \
                as pool:
            specs = list(pool.map(lambda n: self.fetch(n, "/spec"), nodes))
            statses = list(pool.map(lambda n: self.fetch(n, "/stats"),
                                    nodes))
        for n, spec, stats in zip(nodes, specs, statses):
            entry = {"pods": pods_per_node.get(n.metadata.name, 0),
                     "up": spec is not None and stats is not None}
            if spec:
                entry["cores"] = spec.get("num_cores", 0)
                entry["memory_capacity"] = spec.get("memory_capacity", 0)
                totals["cores"] += entry["cores"]
                totals["memory_capacity"] += entry["memory_capacity"]
            if stats:
                cpu = stats.get("cpu", {}).get("usage_core_seconds", 0.0)
                mem = stats.get("memory", {}).get("usage_bytes", 0)
                entry["cpu_usage_core_seconds"] = cpu
                entry["memory_usage"] = mem
                totals["cpu_usage_core_seconds"] += cpu
                totals["memory_usage"] += mem
            if entry["up"]:
                totals["scraped"] += 1
            per_node[n.metadata.name] = entry
        totals["pods"] = sum(pods_per_node.values())
        with self._lock:
            self.model = {"nodes": per_node, "cluster": totals,
                          "timestamp": time.time()}
        self._g_nodes.set(len(nodes))
        self._g_ready.set(totals["scraped"])
        self._g_cores.set(totals["cores"])
        self._g_mem_cap.set(totals["memory_capacity"])
        self._g_cpu.set(totals["cpu_usage_core_seconds"])
        self._g_mem.set(totals["memory_usage"])
        self._g_pods.set(totals["pods"])
        return self.model

    def _scrape_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:
                pass  # a dead kubelet must not kill the aggregator
            self._stop.wait(self.period_s)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        addon: Monitoring = self.server.addon  # type: ignore[attr-defined]
        flight = getattr(addon, "flight", None)
        if self.path.startswith("/metrics"):
            body = addon.registry.render_text().encode()
            ctype = "text/plain; version=0.0.4"
        elif self.path.startswith("/api/v1/model"):
            with addon._lock:
                body = json.dumps(addon.model).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/v1/timeline") and flight is not None:
            body = json.dumps(flight.timeline()).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/v1/alarms") and flight is not None:
            body = json.dumps(flight.alarms()).encode()
            ctype = "application/json"
        elif self.path.startswith("/healthz"):
            body, ctype = b"ok", "text/plain"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


# -- kube-flightrec aggregation ---------------------------------------------


class SLORule:
    """One declarative service-level objective over merged flightrec
    series.

    ``series``: one name or a tuple of names, summed (exact flightrec
    series names, labels included; for ``reduce='p50'/'p95'`` the BASE
    histogram name — bucket series are located by prefix).
    ``reduce``: how the window of samples becomes one value —
    ``last`` (newest sample), ``rate`` (window delta / window seconds,
    for counters), ``p50``/``p95`` (windowed interpolated quantile from
    histogram bucket deltas).
    ``op``: ``ceil`` fires when value > threshold, ``floor`` when
    value < threshold.
    ``for_s``: the violation must persist this long before the alarm
    transitions to firing (threshold-crossing debounce).
    ``service``: restrict to pids whose shard's service name starts with
    this (None = every process).
    ``scope``: combine per-pid values with ``sum`` or ``max`` (max keeps
    the offending pid for the transition record — the per-process RSS
    ceiling's shape).
    ``active_only``: rules meaningful only while load is offered (the
    sustained-binds floor) are suppressed until the harness marks the
    run active and auto-resolve when it ends.
    """

    def __init__(self, name: str, series, *, op: str, threshold: float,
                 reduce: str = "last", window_s: float = 15.0,
                 for_s: float = 0.0, service: Optional[str] = None,
                 scope: str = "sum", active_only: bool = False):
        assert op in ("ceil", "floor"), op
        assert reduce in ("last", "rate", "p50", "p95"), reduce
        assert scope in ("sum", "max"), scope
        self.name = name
        self.series = (series,) if isinstance(series, str) else tuple(series)
        self.op = op
        self.threshold = float(threshold)
        self.reduce = reduce
        self.window_s = float(window_s)
        self.for_s = float(for_s)
        self.service = service
        self.scope = scope
        self.active_only = active_only

    def violated(self, value: float) -> bool:
        return value > self.threshold if self.op == "ceil" \
            else value < self.threshold

    def describe(self) -> Dict[str, object]:
        return {"name": self.name, "series": list(self.series),
                "reduce": self.reduce, "op": self.op,
                "threshold": self.threshold, "window_s": self.window_s,
                "for_s": self.for_s, "service": self.service,
                "scope": self.scope, "active_only": self.active_only}


def default_churn_rules(binds_floor: float = 50.0,
                        solve_p50_ceil_s: float = 2.0,
                        queue_ceil: float = 48.0,
                        rss_ceil_bytes: float = 8 << 30,
                        admitted_e2e_ceil_s: Optional[float] = None
                        ) -> List[SLORule]:
    """The churn-contract SLO set the r11+ records are judged against:
    a clean run must end with zero alarm transitions.

    Quantile-ceiling thresholds MUST sit at or below the histogram's
    top finite bucket (solve: 2.5 s, e2e: 120 s): the windowed quantile
    conservatively reports that bound when the rank overflows the
    envelope, so a threshold above it could never fire — silent exactly
    when the regression is largest."""
    rules = [
        # the headline: work must keep flowing while load is offered
        SLORule("sustained_binds_floor", "scheduler_wave_pods_total",
                reduce="rate", op="floor", threshold=binds_floor,
                window_s=20.0, for_s=30.0, service="scheduler",
                scope="sum", active_only=True),
        # the r08 wall, as a live ceiling instead of a post-mortem
        SLORule("solve_p50_ceiling", "scheduler_wave_solve_seconds",
                reduce="p50", op="ceil", threshold=solve_p50_ceil_s,
                window_s=60.0, for_s=10.0, service="scheduler",
                scope="sum", active_only=True),
        # per-pod queueing envelope (the r10 latency section, live;
        # threshold below the 120 s top bucket so overflow still fires)
        SLORule("e2e_p50_ceiling", "pod_e2e_scheduling_seconds",
                reduce="p50", op="ceil", threshold=100.0,
                window_s=60.0, for_s=10.0, service="scheduler",
                scope="sum", active_only=True),
        # per-WORKER apiserver core share (ROADMAP item 2's width
        # visibility): a healthy worker rides ~1.4 cores at full shape;
        # 4 sustained means a runaway loop, not load
        SLORule("apiserver_cpu_ceiling", "process_cpu_seconds_total",
                reduce="rate", op="ceil", threshold=4.0,
                window_s=20.0, for_s=10.0, service="apiserver",
                scope="max"),
        # BUSY backpressure starts at max-queue; alarm at 75% of default
        SLORule("solverd_queue_saturation", "solverd_queue_depth",
                reduce="last", op="ceil", threshold=queue_ceil,
                for_s=5.0, service="solverd", scope="max"),
        # the three may-never-happen counters, as == 0 invariants
        SLORule("watch_lag_zero",
                ("apiserver_watch_lag_drops_total",
                 "watch_lag_resyncs_total", "watch_events_dropped_total"),
                reduce="last", op="ceil", threshold=0.0, scope="sum"),
        SLORule("parity_divergence_zero",
                ("solverd_mesh_parity_divergent_total",),
                reduce="last", op="ceil", threshold=0.0, scope="sum"),
        # kube-slipstream invariant: during the load window every encoder
        # resync must ride the journal-replay path — a FULL re-encode
        # (any reason) while load is offered is the O(cluster) stall the
        # checkpoint+journal machinery exists to delete. Windowed rate,
        # not last: full syncs during warmup (encoder birth has no
        # checkpoint yet) leave the counter nonzero forever, and must
        # not fire the alarm once the run goes active.
        SLORule("encode_resync_full_zero",
                ('encoder_resync_full_total{reason="no_changelog"}',
                 'encoder_resync_full_total{reason="no_checkpoint"}',
                 'encoder_resync_full_total{reason="window_exceeded"}',
                 'encoder_resync_full_total{reason="planes_changed"}'),
                reduce="rate", op="ceil", threshold=0.0, window_s=30.0,
                service="scheduler", scope="sum", active_only=True),
        SLORule("spans_dropped_zero", ("tracing_spans_dropped",),
                reduce="last", op="ceil", threshold=0.0, scope="sum"),
        # leak detection: any single control-plane process past the lid
        SLORule("process_rss_ceiling", "process_resident_bytes",
                reduce="last", op="ceil", threshold=rss_ceil_bytes,
                for_s=5.0, scope="max"),
        # kube-preempt (the priority-storm scenario ships with its own
        # alarm): a high-priority pod must claim its node promptly —
        # preempt-to-bind p95 above the ceiling while load is offered
        # means the evict+bind path is backing up behind the wave queue.
        # Threshold sits below the histogram's 30 s top finite bucket so
        # an overflow conservatively fires instead of reading 'no data'.
        SLORule("preempt_to_bind_p95_ceiling",
                "scheduler_preemption_bind_seconds",
                reduce="p95", op="ceil", threshold=20.0,
                window_s=60.0, for_s=10.0, service="scheduler",
                scope="sum", active_only=True),
        # eviction-rate visibility: the victims counter's rate rides the
        # timeline as a headline series; the invariant counter must stay 0
        SLORule("preemption_victims_rate_visible",
                "scheduler_preemption_victims_total",
                reduce="rate", op="ceil", threshold=10_000.0,
                window_s=20.0, service="scheduler", scope="sum"),
        SLORule("preemption_higher_evictions_zero",
                ("scheduler_preemption_higher_evictions_total",),
                reduce="last", op="ceil", threshold=0.0, scope="sum"),
        # kube-explain (models/explain.py): a burst of FailedScheduling
        # while load is offered means pods are bouncing off a full or
        # misconfigured cluster faster than they drain — the
        # unschedulable-rate curve rides the timeline as the
        # slo:failed_scheduling_burst headline, and the by-reason
        # breakdown (scheduler_unschedulable_total{reason=...}) in the
        # record's `unschedulable` section says WHY. A clean contract
        # run has zero unschedulable pods: the rule stays no-data quiet.
        SLORule("failed_scheduling_burst",
                "scheduler_unschedulable_pods_total",
                reduce="rate", op="ceil", threshold=50.0,
                window_s=20.0, for_s=10.0, service="scheduler",
                scope="sum", active_only=True),
        # kube-chaos (docs/design/ha.md): a component kill+respawn mid-
        # run must FIRE while the outage is live and RESOLVE once the
        # restart-rate window slides clear — the r14 record requires
        # every outage-driven rule to show both transitions. The
        # counter lives in the churn harness's supervisor (its own
        # /debug/vars target), so only a supervised run can ever move
        # it; active_only keeps teardown kills after the load window
        # from reading as outages.
        SLORule("component_restart", "component_restarts_total",
                reduce="rate", op="ceil", threshold=0.0,
                window_s=20.0, for_s=0.0, scope="sum",
                active_only=True),
        # bounded recovery, live: respawn-to-ready p95 above the
        # ceiling means the control plane is not actually
        # crash-durable at this shape (a kube-store replaying an
        # unbounded WAL, an apiserver worker wedged on a dead store).
        # Threshold sits below the histogram's 60 s top finite bucket
        # so an overflow conservatively fires instead of reading
        # 'no data'.
        SLORule("recovery_time_ceiling", "component_recovery_seconds",
                reduce="p95", op="ceil", threshold=45.0,
                window_s=120.0, for_s=0.0, scope="sum",
                active_only=True),
        # kube-fairshed (docs/design/apiserver-hotpath.md): the
        # starvation-freedom invariant, live — system-flow requests
        # (scheduler binds, reflector list/watch, healthz) are
        # structurally isolated from lower bands, so ANY system shed
        # is an isolation bug. Not active_only: a system shed during
        # warmup or teardown is just as much a bug.
        SLORule("system_flow_shed_zero", ("fairshed_system_shed_total",),
                reduce="last", op="ceil", threshold=0.0, scope="sum"),
        # kube-defrag (descheduler/controller.py): migrations are
        # background maintenance, so their sustained rate must stay far
        # below the scheduler's bind throughput — a descheduler churning
        # pods faster than this is fighting the scheduler for CAS wins
        # (a migration storm), not consolidating. The ceiling is rate-
        # shaped so a legitimate burst (one drain wave) passes and only
        # sustained churn fires; not active_only, because the
        # descheduler by design runs when the scheduler is idle.
        SLORule("defrag_migration_storm", "defrag_migrations_total",
                reduce="rate", op="ceil", threshold=50.0,
                window_s=20.0, for_s=10.0, service="descheduler",
                scope="sum"),
        # the monotone invariant: the acceptance gate structurally drops
        # any voluntary move set that does not strictly improve the
        # fragmentation score, so a wave scoring worse than its
        # mandatory-only outcome can never happen — the counter is an
        # == 0 invariant like preemption_higher_evictions_zero
        SLORule("fragmentation_score_monotone_under_defrag",
                ("defrag_score_regressions_total",),
                reduce="last", op="ceil", threshold=0.0, scope="sum"),
    ]
    if admitted_e2e_ceil_s is not None:
        # the overload contract's headline, armed ONLY when the fairshed
        # backlog governor is (hack/churn_mp passes 10.0 with
        # --fairshed-backlog/--overload): pods the control plane ADMITS
        # must ride through promptly — the governor bounds the
        # created-but-unbound queue, so the admitted-pod e2e p50 stays
        # under this ceiling (the unprotected r11 baseline sat at 37 s,
        # which an UNgoverned clean contract run legitimately does:
        # adding this rule unconditionally would fire on every existing
        # clean heavy shape and break their alarms-[] contract).
        # Threshold must sit on a finite bucket of POD_E2E_BUCKETS
        # (10 s) well below the 120 s top, so an overflow conservatively
        # fires instead of reading 'no data'.
        rules.append(SLORule(
            "admitted_e2e_ceiling", "pod_e2e_scheduling_seconds",
            reduce="p50", op="ceil", threshold=admitted_e2e_ceil_s,
            window_s=60.0, for_s=10.0, service="scheduler",
            scope="sum", active_only=True))
    return rules


class SLOWatchdog:
    """Alarm state machine over rule evaluations: records TRANSITIONS
    (pending->firing after ``for_s`` of sustained violation, firing->
    resolved on recovery) with the offending samples — never one entry
    per bad tick (transition dedup), never a silent recovery."""

    def __init__(self, rules: Sequence[SLORule]):
        self.rules = list(rules)
        self._state = {r.name: {"bad_since": None, "firing": False}
                       for r in self.rules}
        self.transitions: List[dict] = []

    def firing(self) -> List[str]:
        return [n for n, st in self._state.items() if st["firing"]]

    def observe(self, rule: SLORule, value: Optional[float], now_ns: int,
                samples: Sequence = (), active: bool = True,
                pid: Optional[int] = None) -> Optional[dict]:
        """Feed one evaluation; returns the transition recorded (if any).
        ``value=None`` (no data yet) neither fires nor resolves."""
        st = self._state[rule.name]
        if value is None:
            return None
        violated = rule.violated(value) and \
            (active or not rule.active_only)
        if violated:
            if st["bad_since"] is None:
                st["bad_since"] = now_ns
            if not st["firing"] and \
                    (now_ns - st["bad_since"]) / 1e9 >= rule.for_s:
                st["firing"] = True
                tr = {"rule": rule.name, "state": "firing", "t_ns": now_ns,
                      "value": value, "threshold": rule.threshold,
                      "op": rule.op, "samples": [list(s) for s in samples]}
                if pid is not None:
                    tr["pid"] = pid
                self.transitions.append(tr)
                return tr
        else:
            st["bad_since"] = None
            if st["firing"]:
                st["firing"] = False
                tr = {"rule": rule.name, "state": "resolved",
                      "t_ns": now_ns, "value": value,
                      "threshold": rule.threshold, "op": rule.op}
                self.transitions.append(tr)
                return tr
        return None


def _http_vars_fetcher(timeout: float = 5.0) -> Callable[[str], dict]:
    def fetch(url: str) -> dict:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())
    return fetch


class FlightAggregator:
    """Pulls every control-plane process's /debug/vars shard, merges the
    series on the shared monotonic axis, evaluates SLO rules, and
    assembles the record's ``timeline``/``alarms`` sections.

    ``targets``: ``[{"name": ..., "url": "http://host:port",
    "workers": N}, ...]`` — ``workers > 1`` means N processes share the
    URL's listen port via SO_REUSEPORT (apiserver workers) and each poll
    round keeps GETting until all N distinct pids answered or the
    attempt budget runs out (a missed worker is counted in
    ``workers_missed``, never silently absent).
    """

    # Merged-series bound per (pid, series): plenty for a churn run
    # (<= ~600 samples at 1 s), a hard lid for the long-lived
    # cluster-monitoring deployment — without it the aggregator's own
    # RSS grows ~linearly forever and eventually trips the very
    # process_rss_ceiling it watches. Oldest half pruned on overflow
    # (amortized O(1) per append).
    MAX_SAMPLES_PER_SERIES = 4096

    def __init__(self, targets: Sequence[dict],
                 rules: Optional[Sequence[SLORule]] = None,
                 period_s: float = 2.0,
                 fetch: Optional[Callable[[str], dict]] = None):
        self.targets = [dict(t) for t in targets]
        self.period_s = period_s
        self.watchdog = SLOWatchdog(default_churn_rules()
                                    if rules is None else rules)
        self._fetch = fetch or _http_vars_fetcher()
        self._pids: Dict[int, dict] = {}
        self._slo: Dict[str, List[list]] = {}
        self._lock = threading.Lock()
        self._active = False
        self._t0_ns: Optional[int] = None
        self.sample_period_s: Optional[float] = None
        self.poll_errors = 0
        self.workers_missed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FlightAggregator":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="flightrec-aggregator")
            self._thread.start()
        return self

    def stop(self, final_poll: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, self.period_s * 2))
            self._thread = None
        if final_poll:
            try:
                self.poll_once()
            except Exception:
                pass

    def set_active(self, active: bool) -> None:
        """The harness marks the offered-load window; ``active_only``
        rules (the binds floor) evaluate only inside it."""
        self._active = bool(active)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                self.poll_errors += 1
            self._stop.wait(self.period_s)

    # -- pulling -----------------------------------------------------------

    def ingest(self, payload: dict, target: str = "") -> Optional[int]:
        """Merge one /debug/vars payload (tests feed these directly; the
        poll loop feeds fetched ones). Dedup is per (pid, series): only
        samples newer than the newest already merged are appended, so
        SO_REUSEPORT re-drains and overlapping cursors are idempotent."""
        pid = payload.get("pid")
        if pid is None:
            return None
        with self._lock:
            st = self._pids.setdefault(
                pid, {"service": "", "target": target, "series": {},
                      "cursor": 0})
            st["service"] = payload.get("service") or st["service"]
            if payload.get("period_s"):
                self.sample_period_s = payload["period_s"]
            max_t = st["cursor"]
            for name, s in (payload.get("series") or {}).items():
                dst = st["series"].setdefault(
                    name, {"type": s.get("type", ""), "samples": []})
                last = dst["samples"][-1][0] if dst["samples"] else -1
                for p in s.get("samples", ()):
                    if p[0] > last:
                        dst["samples"].append([p[0], p[1]])
                        last = p[0]
                        if p[0] > max_t:
                            max_t = p[0]
                        if self._t0_ns is None or p[0] < self._t0_ns:
                            self._t0_ns = p[0]
                if len(dst["samples"]) > self.MAX_SAMPLES_PER_SERIES:
                    del dst["samples"][:len(dst["samples"]) // 2]
            st["cursor"] = max_t
        return pid

    def poll_once(self) -> None:
        for t in self.targets:
            workers = int(t.get("workers", 1) or 1)
            with self._lock:
                cursors = [st["cursor"] for st in self._pids.values()
                           if st["target"] == t["name"]]
            since = min(cursors) if len(cursors) >= workers else 0
            seen = set()
            for _ in range(max(2, 4 * workers)):
                if len(seen) >= workers:
                    break
                try:
                    payload = self._fetch(
                        f"{t['url'].rstrip('/')}/debug/vars?since={since}")
                except Exception:
                    self.poll_errors += 1
                    break
                pid = self.ingest(payload, target=t["name"])
                if pid is not None:
                    seen.add(pid)
            if len(seen) < workers:
                self.workers_missed += workers - len(seen)
        self.evaluate()

    # -- series access -----------------------------------------------------

    def _match_pids(self, service: Optional[str]) -> List[int]:
        return [pid for pid, st in self._pids.items()
                if service is None or st["service"].startswith(service)]

    def series_samples(self, name: str,
                       service: Optional[str] = None) -> List[Tuple[int, list]]:
        """[(pid, samples)] for one exact series name."""
        with self._lock:
            out = []
            for pid in self._match_pids(service):
                s = self._pids[pid]["series"].get(name)
                if s and s["samples"]:
                    out.append((pid, list(s["samples"])))
        return out

    def now_ns(self) -> int:
        with self._lock:
            cursors = [st["cursor"] for st in self._pids.values()]
        return max(cursors) if cursors else time.monotonic_ns()

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _window(samples: List[list], lo: int) -> List[list]:
        i = len(samples)
        while i > 0 and samples[i - 1][0] >= lo:
            i -= 1
        return samples[i:]

    def _reduce(self, rule: SLORule, now_ns: int):
        """-> (value, pid-or-None). None value = no data yet."""
        lo = now_ns - int(rule.window_s * 1e9)
        if rule.reduce in ("p50", "p95"):
            return self._reduce_quantile(rule, lo), None
        per_pid: Dict[int, float] = {}
        for name in rule.series:
            for pid, samples in self.series_samples(name, rule.service):
                if rule.reduce == "last":
                    # windowed like rate: a dead pid's frozen final
                    # sample (crashed solverd at queue_depth=64, OOMed
                    # worker at peak RSS) must age out of the
                    # evaluation instead of pinning the alarm firing
                    # for the rest of the run — its replacement's
                    # healthy samples are the live truth
                    if samples[-1][0] < lo:
                        continue
                    val = samples[-1][1]
                else:  # rate: window delta over window seconds
                    win = self._window(samples, lo)
                    if len(win) < 2:
                        continue
                    dt = (win[-1][0] - win[0][0]) / 1e9
                    if dt <= 0:
                        continue
                    val = max(0.0, (win[-1][1] - win[0][1]) / dt)
                per_pid[pid] = per_pid.get(pid, 0.0) + val
        if not per_pid:
            return None, None
        if rule.scope == "max":
            pid = max(per_pid, key=lambda p: per_pid[p])
            return per_pid[pid], pid
        return sum(per_pid.values()), None

    def _reduce_quantile(self, rule: SLORule, lo: int) -> Optional[float]:
        """Windowed quantile: per-pid cumulative bucket deltas over the
        window, summed across pids, interpolated like the record-side
        histogram quantiles."""
        q = 0.5 if rule.reduce == "p50" else 0.95
        deltas: Dict[float, float] = {}
        any_series = False
        for base in rule.series:
            prefix = base + "_bucket"
            with self._lock:
                for pid in self._match_pids(rule.service):
                    for name, s in self._pids[pid]["series"].items():
                        if not name.startswith(prefix) or not s["samples"]:
                            continue
                        le_s = name.rsplit('le="', 1)[-1].split('"', 1)[0]
                        le = float("inf") if le_s == "+Inf" else float(le_s)
                        any_series = True
                        win = self._window(s["samples"], lo)
                        if not win:
                            continue
                        # window delta of the cumulative count: newest
                        # in-window value minus the last PRE-window value
                        # (0 at series birth — the whole history is then
                        # inside the window)
                        first_idx = len(s["samples"]) - len(win)
                        base = s["samples"][first_idx - 1][1] \
                            if first_idx > 0 else 0.0
                        deltas[le] = deltas.get(le, 0.0) + win[-1][1] - base
        if not any_series:
            return None
        buckets = sorted(deltas.items())
        count = buckets[-1][1] if buckets else 0.0
        if count <= 0:
            return None
        target = q * count
        prev_le, prev_n = 0.0, 0.0
        for le, n in buckets:
            if n >= target:
                if le == float("inf"):
                    # rank past the finite envelope: report the largest
                    # finite bound — a conservative UNDER-estimate, so
                    # ceiling rules must keep their thresholds at or
                    # below the top finite bucket to stay fireable
                    return prev_le
                span = n - prev_n
                frac = (target - prev_n) / span if span else 1.0
                return prev_le + (le - prev_le) * frac
            prev_le, prev_n = le, n
        return prev_le

    def evaluate(self, now_ns: Optional[int] = None) -> List[dict]:
        """Evaluate every rule once; appends each evaluated value to its
        ``slo:<rule>`` derived series (the timeline's headline curves)
        and feeds the watchdog. Returns new transitions."""
        now = now_ns if now_ns is not None else self.now_ns()
        new = []
        for rule in self.watchdog.rules:
            value, pid = self._reduce(rule, now)
            with self._lock:
                curve = self._slo.setdefault(rule.name, [])
                if value is not None:
                    curve.append([now, value])
                    if len(curve) > self.MAX_SAMPLES_PER_SERIES:
                        del curve[:len(curve) // 2]
                window = curve[-30:]
            tr = self.watchdog.observe(rule, value, now, samples=window,
                                       active=self._active, pid=pid)
            if tr is not None:
                new.append(tr)
        return new

    # -- record assembly ---------------------------------------------------

    def alarms(self) -> List[dict]:
        return list(self.watchdog.transitions)

    def timeline(self, max_points: int = 120,
                 sidecar: str = "") -> Dict[str, object]:
        """The record's ``timeline`` section: the evaluated SLO curves
        (one per rule — the headline series), downsampled to
        ``max_points``, timestamps rebased to seconds from the first
        merged sample. The full-resolution per-pid series live in the
        ``_timeline.json`` sidecar, not the record."""
        with self._lock:
            t0 = self._t0_ns or 0
            series = {}
            for name, pts in self._slo.items():
                if not pts:
                    continue
                stride = max(1, (len(pts) + max_points - 1) // max_points)
                kept = pts[::stride]
                if kept[-1] is not pts[-1]:
                    kept.append(pts[-1])
                series[f"slo:{name}"] = [
                    [round((t - t0) / 1e9, 1), round(v, 4)]
                    for t, v in kept]
            out = {
                "sample_period_s": self.sample_period_s or 0.0,
                "poll_period_s": self.period_s,
                "t0_ns": t0,
                "pids": len(self._pids),
                "poll_errors": self.poll_errors,
                "workers_missed": self.workers_missed,
                "series": series,
                "headline": sorted(series),
                "rules": [r.describe() for r in self.watchdog.rules],
            }
            if sidecar:
                out["sidecar"] = sidecar
        return out

    def sidecar_payload(self) -> Dict[str, object]:
        """The ``<out>_timeline.json`` body: every merged series at full
        resolution (bucket series excluded — the evaluated quantile
        curves are the derived view; raw buckets would triple the file
        for data the SLO curves already summarize), plus the SLO curves
        and the full alarm transition log."""
        with self._lock:
            pids = {}
            for pid, st in self._pids.items():
                pids[str(pid)] = {
                    "service": st["service"], "target": st["target"],
                    "series": {name: s for name, s in st["series"].items()
                               if s.get("type") != "bucket"},
                }
            return {"t0_ns": self._t0_ns or 0,
                    "sample_period_s": self.sample_period_s or 0.0,
                    "pids": pids, "slo": dict(self._slo),
                    "alarms": list(self.watchdog.transitions)}
