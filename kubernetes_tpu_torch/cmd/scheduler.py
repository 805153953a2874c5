"""kube-scheduler binary (ref: plugin/cmd/kube-scheduler/app/server.go:74-102).

Port of ``kubernetes_tpu/cmd/scheduler.py``: the same flags (and their
underscore aliases) against an apiserver speaking the v1 wire.
``--algorithm serial`` (the default) runs the one-pod-at-a-time
``Scheduler`` over ``GenericScheduler``; ``--algorithm tpu-batch`` runs
the wave loop (``BatchScheduler``), one ``commit_solve`` launch a wave on
``--device`` (``cuda`` by default, which raises without a card; ``cpu``
runs the kernel's plain version), and falls back to the serial loop when
the configured policy is one the batch solver cannot model.

``--pipeline`` (with tpu-batch) runs the speculative double-buffered
wave loop; ``--trace`` records each wave's spans and sends the trace
context to the apiserver (drained at ``/debug/trace``); ``--flightrec``
samples every metric series from boot (served at ``/debug/vars``, which
also arms the recorder on its first pull). ``--solver-addr HOST:PORT``
(with tpu-batch) solves each wave through a kube-solverd daemon
(cmd/solverd.py); ``--solver-fallback`` says what a wave does while the
daemon is busy or away (``inprocess``: solve it here on ``--device``;
``requeue``: fail and requeue it), and the deep ``/healthz`` reports a
dead daemon as degraded, not down. ``--mesh`` (with tpu-batch) shards
waves above the mesh node floor over the host's CUDA devices
(parallel/mesh.py): ``auto`` when more than one exists, ``on`` exits
non-zero on a host with one. The reference's ``warmstart.enable()``
(JAX's compile cache) has no counterpart: the kernel build is cached in
``ops/_build/`` by a hash of its sources.

Run: ``python -m kubernetes_tpu_torch.cmd.scheduler --master URL
--algorithm tpu-batch [--pipeline] [--trace] [--flightrec] [--device cpu]
[--solver-addr HOST:PORT] [--metrics-port N]``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Callable, List, Optional

__all__ = ["scheduler_server", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kube-scheduler", exit_on_error=False)
    p.add_argument("--master", default="http://127.0.0.1:8080")
    p.add_argument("--algorithm-provider", "--algorithm_provider",
                   default="DefaultProvider")
    p.add_argument("--policy-config-file", "--policy_config_file", default="")
    p.add_argument("--algorithm", default="serial",
                   choices=["serial", "tpu-batch"])
    p.add_argument("--wave-period", type=float, default=0.05,
                   help="tpu-batch: max wait to accumulate a wave")
    p.add_argument("--solver-addr", "--solver_addr", default="",
                   help="tpu-batch: HOST:PORT of a shared kube-solverd "
                        "daemon that solves every wave (coalescing the "
                        "waves of several schedulers into one launch); "
                        "empty solves in-process")
    p.add_argument("--solver-fallback", "--solver_fallback",
                   choices=("inprocess", "requeue"), default="inprocess",
                   help="tpu-batch with --solver-addr: what a wave does "
                        "while the daemon is busy or away: solve it in "
                        "this process on --device, or fail it so its pods "
                        "requeue and the next wave retries the daemon")
    p.add_argument("--pipeline", action="store_true",
                   help="tpu-batch: speculative double-buffered waves — "
                        "encode and solve wave k+1 against the predicted "
                        "post-commit state while wave k commits; every "
                        "speculation is verified before wave k+1 commits, "
                        "so decisions equal the causal loop's; ignored "
                        "with --algorithm serial")
    p.add_argument("--mesh", choices=("auto", "on", "off"), default="auto",
                   help="tpu-batch: device-mesh solve for in-process waves "
                        "(parallel/mesh.py): auto shards waves above the "
                        "node floor over the host's CUDA devices when >1 "
                        "exists; on requires >1 (exits non-zero "
                        "otherwise); off keeps the single-device path. "
                        "With --solver-addr the daemon's own --mesh "
                        "applies and this one covers the fallback")
    p.add_argument("--pods-axis", "--pods_axis", type=int, default=1,
                   help="mesh 'pods' axis length (see kube-solverd "
                        "--pods-axis)")
    p.add_argument("--prewarm", action="store_true",
                   help="tpu-batch: at boot, once nodes arrive, build and "
                        "load the commit_solve kernel and solve one "
                        "exemplar wave off the wave loop; "
                        "compile_prewarm_ready on /metrics flips to 1 when "
                        "done")
    p.add_argument("--event-qps", "--event_qps", type=float, default=50.0,
                   help="client-side event rate limit (0 disables)")
    p.add_argument("--event-burst", "--event_burst", type=int, default=100)
    p.add_argument("--metrics-port", "--metrics_port", type=int, default=0,
                   help="serve /metrics, /healthz, /debug/pprof, "
                        "/debug/trace and /debug/vars on this port (0 "
                        "disables)")
    p.add_argument("--trace", action="store_true",
                   help="record spans for every wave (drain/prepare/encode/"
                        "solve/commit) into this process's ring and send "
                        "the trace context to the apiserver; drained at "
                        "GET /debug/trace on --metrics-port. Off by default "
                        "(the disabled path is one branch per call site)")
    p.add_argument("--flightrec", action="store_true",
                   help="sample every metric series into a per-process "
                        "(monotonic_ns, value) ring from boot, served "
                        "incrementally at GET /debug/vars on --metrics-port "
                        "(the first pull arms sampling anyway)")
    p.add_argument("--flightrec-period", "--flightrec_period", type=float,
                   default=1.0, help="flight recorder sample period, seconds")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="tpu-batch: where each wave solves; cuda launches "
                        "the commit_solve kernel (and fails without a "
                        "card), cpu runs its plain version")
    return p


def _serve_debug(port: int, service: str = "scheduler", health=None):
    """The binary's observability server: /metrics, deep /healthz (+
    /healthz/ping liveness), /debug/pprof, /debug/trace (this process's
    span shard; ``?peek=1`` reads without resetting the cursor) and
    /debug/vars (the flight recorder's series past ``?since=<ns>``; the
    first pull arms the recorder). ``health`` is a zero-arg callable
    returning componentstatus-style ``(payload dict, ok bool)``; None
    keeps the bare liveness 200. Returns the server (``shutdown()`` stops it)."""
    import json
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from kubernetes_tpu_torch.util import metrics as metrics_pkg
    from kubernetes_tpu_torch.util import pprof as pprof_util
    from kubernetes_tpu_torch.util import tracing
    from kubernetes_tpu_torch.util.metrics import default_registry

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            ctype = "text/plain; charset=utf-8"
            if self.path.startswith("/debug/pprof"):
                parsed = urllib.parse.urlsplit(self.path)
                which = parsed.path[len("/debug/pprof"):].strip("/")
                q = dict(urllib.parse.parse_qsl(parsed.query))
                body = pprof_util.handle(which, q.get("seconds", ""),
                                         q.get("format", ""))
                code = 200 if body is not None else 404
                body = body if body is not None else "not found"
            elif self.path == "/healthz/ping":
                code, body = 200, "ok"  # liveness: process up, serving
            elif self.path.startswith("/healthz"):
                if health is None:
                    code, body = 200, "ok"
                else:
                    try:
                        payload, ok = health()
                    except Exception as e:
                        payload, ok = {"healthy": False,
                                       "error": repr(e)}, False
                    code = 200 if ok else 503
                    body, ctype = json.dumps(payload), "application/json"
            elif self.path == "/metrics":
                code, body = 200, default_registry().render_text()
            elif self.path.startswith("/debug/vars"):
                # the flight recorder's shard: series past the ?since=<ns>
                # cursor; the first pull arms the sampler
                q = dict(urllib.parse.parse_qsl(
                    urllib.parse.urlsplit(self.path).query))
                if not metrics_pkg.flightrec_armed():
                    metrics_pkg.flightrec_arm(service)
                try:
                    since = int(q.get("since", "0") or "0")
                except ValueError:
                    since = 0
                code = 200
                body = json.dumps(metrics_pkg.flightrec_vars(since))
                ctype = "application/json"
            elif self.path.startswith("/debug/trace"):
                # the span shard (?peek=1 reads without resetting the
                # cursor); shards of several processes merge with
                # tracing.chrome_trace
                q = dict(urllib.parse.parse_qsl(
                    urllib.parse.urlsplit(self.path).query))
                code = 200
                body = json.dumps(tracing.drain(
                    reset=q.get("peek") not in ("1", "true")))
                ctype = "application/json"
            else:
                code, body = 404, "not found"
            raw = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    srv = ThreadingHTTPServer(("127.0.0.1", port), H)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name=f"{service}-debug-http").start()
    return srv


def _scheduler_health(master: str, solver_addr: str = ""):
    """Deep-health probe of the scheduler binary: can it reach the
    binder (the apiserver it commits to) and, when configured, the shared
    solver daemon. componentstatus-style payload; the caller answers 503
    when unhealthy. A dead daemon is degraded, not down: its item reads
    failure, but the waves fall back to in-process solves, so it does not
    fail the check."""
    import urllib.parse

    from kubernetes_tpu_torch import probe

    def health():
        u = urllib.parse.urlparse(master)
        st, msg = probe.probe_http(u.hostname, u.port, "/healthz/ping")
        ok = st == probe.SUCCESS
        items = [{"name": "binder", "status": st,
                  "message": f"apiserver {master} reachable" if ok
                  else msg}]
        if solver_addr:
            host, _, sport = solver_addr.rpartition(":")
            sst, smsg = probe.probe_tcp(host or "127.0.0.1", int(sport))
            items.append({"name": "solver", "status": sst,
                          "message": smsg if sst != probe.SUCCESS else
                          f"kube-solverd {solver_addr} reachable"})
        return ({"kind": "ComponentStatusList", "healthy": ok,
                 "items": items}, ok)

    return health


def build_scheduler(opts):
    """-> (factory, scheduler) from parsed flags."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.client.record import (AsyncEventRecorder,
                                                    EventRecorder)
    from kubernetes_tpu_torch.scheduler import plugins as schedplugins
    from kubernetes_tpu_torch.scheduler.driver import (ConfigFactory,
                                                       Scheduler)

    # the user-agent names the scheduler's traffic to the apiserver's
    # flow classifier (reflector list/watch and the wave commit)
    client = Client(HTTPTransport(opts.master, user_agent="kube-scheduler"))
    # async like the reference's StartRecording goroutine (event.go:53):
    # recording must never stall the loop on an API write
    recorder = AsyncEventRecorder(
        EventRecorder(client, api.EventSource(
            component=api.DefaultSchedulerName)),
        qps=opts.event_qps, burst=opts.event_burst)
    factory = ConfigFactory(client)

    policy = None
    if opts.policy_config_file:
        with open(opts.policy_config_file) as f:
            policy = schedplugins.load_policy(f.read())
    config = factory.create(provider=opts.algorithm_provider,
                            policy=policy, recorder=recorder,
                            solver_addr=opts.solver_addr,
                            solver_fallback=opts.solver_fallback,
                            pipeline=opts.pipeline, mesh=opts.mesh,
                            pods_axis=opts.pods_axis,
                            prewarm=opts.prewarm)
    if opts.pipeline and opts.algorithm != "tpu-batch":
        print("kube-scheduler: --pipeline requires --algorithm tpu-batch; "
              "ignoring", file=sys.stderr)
    if opts.algorithm == "tpu-batch":
        from kubernetes_tpu_torch.models.policy import (UnsupportedPolicy,
                                                        batch_policy_from)
        from kubernetes_tpu_torch.scheduler import tpu_batch
        try:
            batch_policy = batch_policy_from(opts.algorithm_provider, policy)
        except UnsupportedPolicy as e:
            # never silently solve a different problem than configured:
            # fall back to the serial driver, which runs the plugin
            # functions directly
            print(f"kube-scheduler: tpu-batch cannot model this "
                  f"configuration ({e}); falling back to serial",
                  file=sys.stderr)
            return factory, Scheduler(config)
        try:
            sched = tpu_batch.BatchScheduler(
                config, factory, client, wave_linger_s=opts.wave_period,
                batch_policy=batch_policy, device=opts.device)
        except Exception:
            # no scheduler to run: stop the reflectors create() started
            # and the event recorder
            factory.stop(join=True)
            recorder.stop()
            raise
        return factory, sched
    return factory, Scheduler(config)


def scheduler_server(argv: List[str],
                     ready: Optional[threading.Event] = None,
                     stop: Optional[threading.Event] = None,
                     on_built: Optional[Callable[[object], None]] = None
                     ) -> int:
    """Run the binary until ``stop`` is set (or SIGTERM/Ctrl-C). Returns
    0 on a clean stop, 1 when a flag needs an unported feature or the
    wave loop stopped on a fault (a failed prewarm, an unported wave),
    2 on a bad flag. An embedding caller's ``on_built(scheduler)`` gets
    the scheduler (``Scheduler`` or ``BatchScheduler``) before its loop
    starts. On the way out it turns off the tracing it turned on and
    disarms the flight recorder it (or a /debug/vars pull) armed, so an
    embedding process is left as it was."""
    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.parallel.mesh import MeshUnavailable, maybe_mesh
    from kubernetes_tpu_torch.util import metrics, tracing

    try:
        if opts.algorithm == "tpu-batch":
            # refuse --mesh on before the caches start listing
            maybe_mesh(opts.mesh, opts.pods_axis)
        factory, sched = build_scheduler(opts)
    except MeshUnavailable as e:
        print(f"kube-scheduler: {e}", file=sys.stderr)
        return 1
    was_armed = metrics.flightrec_armed()
    if opts.trace:
        tracing.enable("scheduler")
    if opts.flightrec:
        metrics.flightrec_arm("scheduler", period_s=opts.flightrec_period)
    if on_built is not None:
        on_built(sched)
    srv = None
    if opts.metrics_port:
        srv = _serve_debug(opts.metrics_port, service="scheduler",
                           health=_scheduler_health(opts.master,
                                                    opts.solver_addr))
    sched.run()
    print(f"kube-scheduler running ({opts.algorithm})", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    rc = 0
    try:
        while not stop.wait(0.2):
            fault = getattr(sched, "fault", None)
            if fault is not None:
                print(f"kube-scheduler: wave loop stopped: {fault!r}",
                      file=sys.stderr)
                rc = 1
                break
    except KeyboardInterrupt:
        pass
    sched.stop()
    factory.stop()
    sched.config.recorder.stop()
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if opts.trace:
        tracing.disable()
    if not was_armed:
        metrics.flightrec_disarm()
    return rc


def main() -> int:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    return scheduler_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
