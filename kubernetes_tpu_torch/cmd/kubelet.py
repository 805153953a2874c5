"""kubelet binary (ref: cmd/kubelet/app/server.go RunKubelet:324).

Port of ``kubernetes_tpu/cmd/kubelet.py``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

__all__ = ["kubelet_server", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubelet", exit_on_error=False)
    p.add_argument("--api-servers", "--api_servers",
                   default="http://127.0.0.1:8080")
    p.add_argument("--hostname-override", "--hostname_override", default="")
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10250)
    p.add_argument("--root-dir", "--root_dir", default="/var/lib/kubelet")
    p.add_argument("--config", default="",
                   help="static pod manifest dir (file source)")
    p.add_argument("--manifest-url", "--manifest_url", default="")
    p.add_argument("--sync-frequency", "--sync_frequency",
                   type=float, default=10.0)
    p.add_argument("--register-node", "--register_node", action="store_true",
                   help="create our Node object on startup")
    p.add_argument("--node-cpu", default="4")
    p.add_argument("--node-memory", default="8Gi")
    p.add_argument("--allow-privileged", "--allow_privileged",
                   action="store_true",
                   help="if set, allow containers to request privileged "
                        "mode (ref: the reference's --allow_privileged)")
    p.add_argument("--container-runtime", "--container_runtime",
                   default="process", choices=["process", "fake"],
                   help="process = real local process groups with the "
                        "native pause sandbox; fake = in-memory double")
    return p


def build_kubelet(opts):
    import socket

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.client.record import AsyncEventRecorder, EventRecorder
    from kubernetes_tpu_torch.kubelet.config import (ApiserverSource, FileSource,
                                               HTTPSource, PodConfig)
    from kubernetes_tpu_torch.kubelet.kubelet import Kubelet
    from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime
    from kubernetes_tpu_torch.kubelet.server import KubeletServer
    from kubernetes_tpu_torch.volume.plugins import (ExecMounter,
                                               RefusingDiskManager,
                                               new_default_plugin_mgr)

    from kubernetes_tpu_torch import capabilities

    # ref: cmd/kubelet/app/server.go:333 SetupCapabilities
    capabilities.setup(getattr(opts, "allow_privileged", False))

    hostname = opts.hostname_override or socket.gethostname()
    client = Client(HTTPTransport(opts.api_servers, user_agent="kubelet"))
    # async like the scheduler (and the reference's StartRecording
    # goroutine, event.go:53): the sync loop was posting events
    # SYNCHRONOUSLY, stalling pod lifecycle on an apiserver round-trip
    # per event — a slow apiserver turned every container start into a
    # blocking write. Bounded queue + background worker; drops are
    # counted (event_recorder_dropped_total), never a stalled sync loop.
    recorder = AsyncEventRecorder(
        EventRecorder(client, api.EventSource(component="kubelet",
                                              host=hostname)),
        qps=50.0, burst=100)
    # the runtime seam (ref: dockertools): ProcessRuntime runs pods as real
    # local process groups with the native pause sandbox; FakeRuntime is
    # the in-memory double for tests/demos
    if opts.container_runtime == "process":
        from kubernetes_tpu_torch.kubelet.process_runtime import ProcessRuntime

        runtime = ProcessRuntime(opts.root_dir)
    else:
        runtime = FakeRuntime()
    # real mounter so NFS mounts actually happen (or fail loudly); PD attach
    # refuses outright — there is no cloud disk backend on this host — so
    # such pods get a mount error instead of an empty dir
    volume_mgr = new_default_plugin_mgr(opts.root_dir, kubelet_client=client,
                                        mounter=ExecMounter(),
                                        disk_manager=RefusingDiskManager())
    # service env var injection (ref: cmd/kubelet/app/server.go wiring a
    # cache.NewListWatchFromClient("services") into kl.serviceLister):
    # a reflector-backed cache so pod starts never block on the apiserver
    from kubernetes_tpu_torch.client.cache import Reflector, Store

    svc_store = Store()
    Reflector(client.services(api.NamespaceAll).list_watch(), svc_store,
              name="kubelet-services").run()

    kubelet = Kubelet(hostname, runtime, client=client, recorder=recorder,
                      resync_period=opts.sync_frequency,
                      volume_mgr=volume_mgr, service_lister=svc_store.list)

    pod_config = PodConfig()
    sources = [ApiserverSource(pod_config, client, hostname)]
    if opts.config:
        sources.append(FileSource(pod_config, opts.config, hostname,
                                  period=opts.sync_frequency))
    if opts.manifest_url:
        sources.append(HTTPSource(pod_config, opts.manifest_url, hostname,
                                  period=opts.sync_frequency))

    if opts.register_node:
        from kubernetes_tpu_torch.api import errors
        from kubernetes_tpu_torch.api.quantity import Quantity

        def register():
            node = api.Node(
                metadata=api.ObjectMeta(name=hostname),
                spec=api.NodeSpec(capacity={
                    api.ResourceCPU: Quantity(opts.node_cpu),
                    api.ResourceMemory: Quantity(opts.node_memory)}))
            # keep retrying: the apiserver routinely comes up after the
            # kubelet in a multi-process boot (ref: NodeController
            # RegisterNodes retry loop)
            import time as _time
            while True:
                try:
                    client.nodes().create(node)
                    return
                except errors.StatusError as e:
                    if errors.is_already_exists(e):
                        return
                    print(f"kubelet: node registration rejected: {e}",
                          file=sys.stderr)
                except Exception as e:
                    print(f"kubelet: apiserver unreachable, retrying "
                          f"registration: {e}", file=sys.stderr)
                _time.sleep(1.0)

        threading.Thread(target=register, daemon=True,
                         name="kubelet-register").start()

    stats = None
    if opts.container_runtime == "process":
        # per-container /proc accounting: each container is a real process
        from kubernetes_tpu_torch.kubelet.stats import ProcessRuntimeStatsProvider
        stats = ProcessRuntimeStatsProvider(runtime)
    server = KubeletServer(kubelet, host=opts.address, port=opts.port,
                           stats=stats)
    return kubelet, pod_config, sources, server


def kubelet_server(argv: List[str],
                   ready: Optional[threading.Event] = None,
                   stop: Optional[threading.Event] = None) -> int:
    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    kubelet, pod_config, sources, server = build_kubelet(opts)
    for src in sources:
        src.run()
    kubelet.run(pod_config)
    server.start()
    print(f"kubelet {kubelet.hostname} serving on "
          f"{opts.address}:{server.port}", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    server.stop()
    for src in sources:
        src.stop()
    kubelet.stop()
    rec = getattr(kubelet, "recorder", None)
    if rec is not None and hasattr(rec, "stop"):
        rec.stop()  # drain + join the async posting worker
    return 0


def main() -> int:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    return kubelet_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
