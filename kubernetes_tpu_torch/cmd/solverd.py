"""kube-solverd binary — the shared batch-solver daemon.

Port of ``kubernetes_tpu/cmd/solverd.py``: the same flags (and their
underscore aliases). One daemon owns the card and serves every scheduler
worker (``kube-scheduler --solver-addr``) over a local socket; waves that
arrive within the gather window solve as one launch of the commit_solve
kernel, one block per wave (solver/service.py).

``--device`` (``cuda`` by default, which fails without a card; ``cpu``
runs the kernel's plain version) picks where waves solve. ``--mesh``
turns on the device-mesh dispatch (solver/mesh_exec.py): ``auto`` when
the host has more than one CUDA device, ``on`` demands more than one (and
exits non-zero on a host with one); single waves above
``--mesh-min-nodes`` that the kernel cannot take then solve from
device-resident node shards. ``--trace-device DIR`` records a
``torch.profiler`` trace of the daemon's run into DIR, written as a
Chrome trace when the daemon stops. The reference's ``warmstart.enable()``
(JAX's compile cache) has no counterpart: the kernel build is cached in
``ops/_build/`` by a hash of its sources; the mesh dispatch's calibration
persists in ``util/warmstart.mesh_cal_path()``.

Run: ``python -m kubernetes_tpu_torch.cmd.solverd [--port 10450]
[--gather-window 0.003] [--max-batch 16] [--max-queue 64] [--device cpu]
[--mesh on --mesh-dispatch shard] [--prewarm --prewarm-nodes N]
[--metrics-port N]``.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import List, Optional

__all__ = ["solverd_server", "main"]

DEFAULT_PORT = 10450


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kube-solverd", exit_on_error=False)
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--gather-window", "--gather_window", type=float,
                   default=0.003,
                   help="seconds to gather concurrent waves into one "
                        "batched solve (wave coalescing)")
    p.add_argument("--max-batch", "--max_batch", type=int, default=16,
                   help="max waves per batched launch (one block each)")
    p.add_argument("--max-queue", "--max_queue", type=int, default=64,
                   help="bounded request queue; beyond this, requests get "
                        "an immediate BUSY reply (backpressure) instead of "
                        "unbounded latency")
    p.add_argument("--cache-entries", "--cache_entries", type=int,
                   default=64,
                   help="delta-wire resident plane cache entries (one per "
                        "worker thread x shape bucket); evictions cost the "
                        "evicted client one full-frame resync")
    p.add_argument("--metrics-port", "--metrics_port", type=int, default=0,
                   help="serve /metrics, /healthz and /debug/pprof on this "
                        "port (0 disables)")
    p.add_argument("--mesh", choices=("auto", "on", "off"), default="auto",
                   help="device-mesh dispatch (solver/mesh_exec.py): auto "
                        "enables it whenever >1 CUDA device is attached; "
                        "on requires >1 (exits non-zero otherwise); waves "
                        "above --mesh-min-nodes that the kernel cannot take "
                        "then solve from device-resident node shards")
    p.add_argument("--pods-axis", "--pods_axis", type=int, default=1,
                   help="mesh 'pods' axis length; the rest of the devices "
                        "shard the node axis (pods_axis=1 is pure "
                        "tensor-parallel over nodes)")
    p.add_argument("--mesh-min-nodes", "--mesh_min_nodes", type=int,
                   default=None,
                   help="node-count floor for the mesh dispatch (default "
                        "parallel.mesh.DEFAULT_MESH_MIN_NODES); smaller "
                        "waves keep the coalesced single-device path")
    p.add_argument("--mesh-dispatch", "--mesh_dispatch",
                   choices=("auto", "shard", "single"), default="auto",
                   help="node-axis layout: auto times the sharded loop "
                        "against the single-device layout once per shape "
                        "(persisted in the warm-start dir) and runs the "
                        "winner; shard/single pin a layout")
    p.add_argument("--mesh-probe", "--mesh_probe",
                   choices=("first", "all", "off"), default="first",
                   help="live bit-identity probe: re-solve mesh-path "
                        "waves in the other layout and compare bitwise "
                        "(first = once per daemon run)")
    p.add_argument("--prewarm", action="store_true",
                   help="at boot, launch the shape buckets implied by "
                        "--prewarm-nodes/-pods/-batch off the solve path, "
                        "before the first request (the kernel builds on "
                        "the first); compile_prewarm_ready flips to 1 on "
                        "/metrics when done. The fill-trigger prewarm runs "
                        "regardless.")
    p.add_argument("--prewarm-nodes", "--prewarm_nodes", type=int,
                   default=0,
                   help="declared cluster node count for the boot "
                        "prewarm set (pow-2 rounded)")
    p.add_argument("--prewarm-pods", "--prewarm_pods", type=int,
                   default=1024,
                   help="top of the pod-axis bucket ladder to prewarm "
                        "(ladder descends to 256)")
    p.add_argument("--prewarm-batch", "--prewarm_batch", type=int,
                   default=1,
                   help="waves per launch to prewarm in addition to 1 "
                        "(set to the expected concurrent-worker count)")
    p.add_argument("--trace", action="store_true",
                   help="record queue-wait + solve spans, attached to the "
                        "requesting wave's trace when the v3 frame carries "
                        "one; drain via GET /debug/trace on "
                        "--metrics-port. Default OFF.")
    p.add_argument("--flightrec", action="store_true",
                   help="sample every metric series into a per-process "
                        "(monotonic_ns, value) ring from boot, served "
                        "incrementally at GET /debug/vars on "
                        "--metrics-port (the first pull arms sampling "
                        "anyway)")
    p.add_argument("--flightrec-period", "--flightrec_period", type=float,
                   default=1.0,
                   help="flight recorder sample period, seconds")
    p.add_argument("--trace-device", "--trace_device", default="",
                   help="directory for a torch.profiler trace of the "
                        "daemon's run (host and device activity), written "
                        "as a Chrome trace on shutdown. Empty disables.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where waves solve; cuda launches the commit_solve "
                        "kernel (and fails without a card), cpu runs its "
                        "plain version")
    return p


def _solverd_health(srv):
    """Deep-health probe of the daemon: the device it solves on is still
    there, and — when the mesh dispatch is on — the device mesh itself.
    componentstatus-style payload; the metrics-port server answers 503
    when unhealthy."""
    from kubernetes_tpu_torch import probe

    def health():
        import torch

        dev = getattr(srv, "device", None)
        if dev is None:     # no device pinned: probe the runtime itself
            dev = torch.device("cuda" if torch.cuda.is_available()
                               else "cpu")
        if dev.type == "cuda":
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            ok = n > (dev.index or 0)
            msg = f"cuda, {n} device(s)"
        else:
            ok, msg = True, "cpu, 1 device(s)"
        items = [{"name": "backend",
                  "status": probe.SUCCESS if ok else probe.FAILURE,
                  "message": msg}]
        me = getattr(srv, "_mesh_exec", None)
        if me is not None:
            shards = getattr(me, "node_shards", 0)
            st = probe.SUCCESS if shards >= 1 else probe.FAILURE
            items.append({"name": "mesh", "status": st,
                          "message": f"{shards} node-shard(s) x "
                                     f"{getattr(me, 'pods_axis', 1)} pods"})
            ok = ok and st == probe.SUCCESS
        return ({"kind": "ComponentStatusList", "healthy": ok,
                 "items": items}, ok)

    return health


def _start_device_trace(opts, device):
    """A torch.profiler run over the daemon's life, or None. A profiler
    that cannot start is reported and the daemon runs without it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except (RuntimeError, OSError) as e:
        print(f"kube-solverd: --trace-device unavailable: {e}",
              file=sys.stderr)
        return None
    print(f"kube-solverd: device trace -> {opts.trace_device}",
          file=sys.stderr)
    return prof


def _stop_device_trace(prof, out_dir: str) -> None:
    if prof is None:
        return
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "solverd_trace.json"))


def solverd_server(argv: List[str],
                   ready: Optional[threading.Event] = None,
                   stop: Optional[threading.Event] = None) -> int:
    """Run the daemon until ``stop`` is set (or SIGTERM/Ctrl-C). Returns
    0 on a clean stop, 1 when ``--mesh on`` finds one device or none, 2
    on a bad flag. On the way out it turns off the tracing it turned on and
    disarms the flight recorder it armed."""
    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.parallel.mesh import MeshUnavailable
    from kubernetes_tpu_torch.solver.service import SolverService
    from kubernetes_tpu_torch.util import metrics, tracing

    try:
        srv = SolverService(host=opts.address, port=opts.port,
                            gather_window_s=opts.gather_window,
                            max_batch=opts.max_batch,
                            max_queue=opts.max_queue,
                            cache_entries=opts.cache_entries,
                            mesh=opts.mesh, pods_axis=opts.pods_axis,
                            mesh_min_nodes=opts.mesh_min_nodes,
                            mesh_dispatch=opts.mesh_dispatch,
                            mesh_probe=opts.mesh_probe,
                            prewarm=opts.prewarm,
                            prewarm_nodes=opts.prewarm_nodes,
                            prewarm_pods=opts.prewarm_pods,
                            prewarm_batch=opts.prewarm_batch,
                            device=opts.device)
    except MeshUnavailable as e:
        print(f"kube-solverd: {e}", file=sys.stderr)
        return 1
    was_armed = metrics.flightrec_armed()
    if opts.trace:
        tracing.enable("solverd")
    if opts.flightrec:
        metrics.flightrec_arm("solverd", period_s=opts.flightrec_period)
    device_trace = (_start_device_trace(opts, srv.device)
                    if opts.trace_device else None)
    debug = None
    if opts.metrics_port:
        from kubernetes_tpu_torch.cmd.scheduler import _serve_debug
        debug = _serve_debug(opts.metrics_port, service="solverd",
                             health=_solverd_health(srv))
    me = srv._mesh_exec
    mesh_desc = (f", mesh {me.node_shards} node-shards x "
                 f"{me.pods_axis} pods (min {me.min_nodes} nodes, "
                 f"dispatch {opts.mesh_dispatch})"
                 if me is not None else ", mesh off")
    print(f"kube-solverd listening on {srv.address} "
          f"(gather {opts.gather_window * 1000:.1f}ms, "
          f"batch<= {opts.max_batch}, queue<= {opts.max_queue}, "
          f"device {srv.device}{mesh_desc})",
          file=sys.stderr, flush=True)
    srv.start()
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        while not stop.wait(0.2):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        srv.join()
        _stop_device_trace(device_trace, opts.trace_device)
        if debug is not None:
            debug.shutdown()
            debug.server_close()
        if opts.trace:
            tracing.disable()
        if not was_armed:
            metrics.flightrec_disarm()
    return 0


def main() -> int:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    # kill -USR1 <pid> dumps every thread's stack to stderr: the tool of
    # last resort when the daemon wedges too hard for /debug/pprof
    import faulthandler
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    return solverd_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
