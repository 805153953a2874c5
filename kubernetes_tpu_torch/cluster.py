"""In-process cluster harness (ref: cmd/integration/integration.go:67-246 +
cmd/kubernetes/ standalone binary).

Starts, in one process: the master (API + registries + admission), the
scheduler (serial or TPU batch), the controller manager, and N kubelets
backed by FakeRuntimes — the reference's flagship integration setup ("two
kubelets with FakeDockerClients"). This is both the integration-test fixture
and the standalone demo cluster.

Port of ``kubernetes_tpu/cluster.py``, without ``algorithm_override``,
which no caller sets (the port's ``ConfigFactory.create`` has no such
seam).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.apiserver.master import Master, MasterConfig
from kubernetes_tpu_torch.client.client import Client, InProcessTransport
from kubernetes_tpu_torch.client.record import EventRecorder
from kubernetes_tpu_torch.controllers.manager import (
    ControllerManager,
    ControllerManagerConfig,
)
from kubernetes_tpu_torch.kubelet import (
    ApiserverSource,
    FakeRuntime,
    FileSource,
    Kubelet,
    PodConfig,
)
from kubernetes_tpu_torch.scheduler.driver import ConfigFactory, Scheduler

__all__ = ["ClusterConfig", "Cluster"]


@dataclass
class ClusterConfig:
    num_nodes: int = 2
    node_cpu: str = "8"
    node_memory: str = "16Gi"
    node_labels: Dict[str, str] = field(default_factory=dict)
    scheduler_provider: str = "DefaultProvider"
    rc_sync_period: float = 0.5
    endpoints_sync_period: float = 0.5
    node_sync_period: float = 0.5
    kubelet_resync: float = 0.5
    node_poll_period: float = 0.5
    static_pod_dirs: Dict[str, str] = field(default_factory=dict)  # node -> dir
    kubelet_http: bool = False      # start a KubeletServer per node
    batch_scheduler: bool = False   # tpu-batch wave scheduler instead of serial
    process_runtime: bool = False   # real local-process runtime (native pause)
    runtime_root: str = ""          # ProcessRuntime state dir ("" = tmpdir)
    device: Optional[str] = None    # tpu-batch waves solve here (None = cuda)


class _NodeHandle:
    def __init__(self, name: str, runtime: FakeRuntime, kubelet: Kubelet,
                 config: PodConfig, sources: list):
        self.name = name
        self.runtime = runtime
        self.kubelet = kubelet
        self.config = config
        self.sources = sources
        self.healthy = True  # flipped by tests to simulate node death
        self.server = None   # KubeletServer when ClusterConfig.kubelet_http


class Cluster:
    def __init__(self, config: Optional[ClusterConfig] = None):
        self.config = config or ClusterConfig()
        c = self.config
        self.master = Master(MasterConfig())
        self.client = Client(InProcessTransport(self.master))
        self.nodes: Dict[str, _NodeHandle] = {}

        static_nodes = [
            api.Node(metadata=api.ObjectMeta(name=f"node-{i}",
                                             labels=dict(c.node_labels)),
                     spec=api.NodeSpec(capacity={
                         api.ResourceCPU: Quantity(c.node_cpu),
                         api.ResourceMemory: Quantity(c.node_memory)}))
            for i in range(c.num_nodes)]

        # kubelets (ref: integration.go:131-246 startKubelet x2)
        self._runtime_tmp: Optional[str] = None
        if c.process_runtime and not c.runtime_root:
            import tempfile

            self._runtime_tmp = tempfile.mkdtemp(prefix="ktpu-runtime-")
        for node in static_nodes:
            name = node.metadata.name
            if c.process_runtime:
                from kubernetes_tpu_torch.kubelet import ProcessRuntime

                root = os.path.join(c.runtime_root or self._runtime_tmp, name)
                runtime = ProcessRuntime(root)
            else:
                runtime = FakeRuntime(ip_base=f"10.{88 + len(self.nodes)}.0.")
            recorder = EventRecorder(self.client, api.EventSource(
                component="kubelet", host=name))
            kubelet = Kubelet(name, runtime, client=self.client,
                              recorder=recorder, resync_period=c.kubelet_resync)
            pod_config = PodConfig()
            sources = [ApiserverSource(pod_config, self.client, name)]
            if name in c.static_pod_dirs:
                sources.append(FileSource(pod_config, c.static_pod_dirs[name],
                                          name, period=c.kubelet_resync))
            self.nodes[name] = _NodeHandle(name, runtime, kubelet, pod_config,
                                           sources)

        # controller manager, with the node prober wired to kubelet health
        self.controller_manager = ControllerManager(
            self.client, ControllerManagerConfig(
                rc_sync_period=c.rc_sync_period,
                endpoints_sync_period=c.endpoints_sync_period,
                node_sync_period=c.node_sync_period,
                static_nodes=static_nodes,
                node_prober=self._probe_node))

        # scheduler (ref: plugin/cmd/kube-scheduler wiring)
        self.scheduler_factory = ConfigFactory(
            self.client, node_poll_period=c.node_poll_period)
        self._scheduler: Optional[Scheduler] = None

    def _probe_node(self, node: api.Node) -> bool:
        handle = self.nodes.get(node.metadata.name)
        return handle.healthy if handle is not None else False

    # ------------------------------------------------------------------
    def start(self) -> "Cluster":
        self.controller_manager.run()
        sched_config = self.scheduler_factory.create(
            provider=self.config.scheduler_provider,
            recorder=EventRecorder(self.client, api.EventSource(
                component=api.DefaultSchedulerName)))
        if self.config.batch_scheduler:
            from kubernetes_tpu_torch.scheduler.tpu_batch import BatchScheduler
            self._scheduler = BatchScheduler(
                sched_config, self.scheduler_factory, self.client,
                device=self.config.device).run()
        else:
            self._scheduler = Scheduler(sched_config).run()
        for handle in self.nodes.values():
            for src in handle.sources:
                src.run()
            handle.kubelet.run(handle.config)
            if self.config.kubelet_http:
                from kubernetes_tpu_torch.kubelet.server import KubeletServer
                stats = None
                if self.config.process_runtime:
                    from kubernetes_tpu_torch.kubelet.stats import (
                        ProcessRuntimeStatsProvider,
                    )
                    stats = ProcessRuntimeStatsProvider(handle.runtime)
                handle.server = KubeletServer(handle.kubelet,
                                              stats=stats).start()
        return self

    def node_locator(self, name: str):
        """node name -> kubelet server "host:port" — plug into
        APIServer(node_locator=...) so /proxy/nodes/<n>/... resolves."""
        handle = self.nodes.get(name)
        if handle is None or handle.server is None:
            return None
        return f"127.0.0.1:{handle.server.port}"

    def pod_logs(self, namespace: str, name: str, container: str = "") -> str:
        """Fetch container logs from the owning node's kubelet server, the
        path kubectl log takes (ref: kubectl/cmd/log.go via
        /proxy/minions/<host>/containerLogs/...)."""
        import urllib.request

        pod = self.client.pods(namespace).get(name)
        host = pod.spec.host or pod.status.host
        if not host or host not in self.nodes:
            raise RuntimeError(f"pod {namespace}/{name} is not bound")
        handle = self.nodes[host]
        container = container or pod.spec.containers[0].name
        if handle.server is None:
            raise RuntimeError("kubelet HTTP servers not enabled "
                               "(ClusterConfig.kubelet_http)")
        url = (f"http://127.0.0.1:{handle.server.port}"
               f"/containerLogs/{namespace}/{name}/{container}")
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.read().decode()

    def pod_exec(self, namespace: str, name: str, container: str,
                 command) -> tuple:
        """-> (exit_code, output) through the owning node's /run endpoint
        (kubectl exec path); nonzero exit arrives as a 500 whose body is
        the command output."""
        import urllib.error
        import urllib.parse
        import urllib.request

        pod = self.client.pods(namespace).get(name)
        host = pod.spec.host or pod.status.host
        handle = self.nodes.get(host)
        if handle is None or handle.server is None:
            raise RuntimeError("exec needs kubelet HTTP servers "
                               "(ClusterConfig.kubelet_http)")
        container = container or pod.spec.containers[0].name
        qs = urllib.parse.urlencode([("cmd", c) for c in command])
        url = (f"http://127.0.0.1:{handle.server.port}"
               f"/run/{namespace}/{name}/{container}?{qs}")
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return 0, r.read().decode()
        except urllib.error.HTTPError as e:
            return 1, e.read().decode()

    def kubectl_factory(self, out=None, err=None):
        """A kubectl Factory bound to this cluster (in-process client +
        kubelet log/exec/port-forward sources)."""
        from kubernetes_tpu_torch.kubectl.cmd import Factory
        return Factory(self.client, out=out, err=err,
                       pod_logs=self.pod_logs,
                       pod_exec=self.pod_exec,
                       node_locator=self.node_locator)

    def stop(self) -> None:
        if self._scheduler is not None:
            self._scheduler.stop()
        self.scheduler_factory.stop()
        self.controller_manager.stop()
        for handle in self.nodes.values():
            for src in handle.sources:
                src.stop()
            handle.kubelet.stop()
            if handle.server is not None:
                handle.server.stop()
            if hasattr(handle.runtime, "shutdown"):
                handle.runtime.shutdown()
        if self._runtime_tmp:
            import shutil

            shutil.rmtree(self._runtime_tmp, ignore_errors=True)

    # ------------------------------------------------------------------
    # test helpers (ref: integration.go podsOnMinions / waitForPodRunning)
    # ------------------------------------------------------------------
    def wait_for(self, predicate, timeout: float = 10.0,
                 interval: float = 0.05) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if predicate():
                    return True
            except Exception:
                pass
            time.sleep(interval)
        return False

    def wait_pods_running(self, n: int, label_selector: str = "",
                          timeout: float = 15.0) -> bool:
        def check():
            pods = self.client.pods(api.NamespaceAll).list(
                label_selector=label_selector).items
            return sum(1 for p in pods
                       if p.status.phase == api.PodRunning) >= n
        return self.wait_for(check, timeout)

    def pods_on_node(self, node_name: str) -> List[str]:
        handle = self.nodes[node_name]
        names = set()
        for r in handle.runtime.list_containers():
            p = r.parsed
            if p:
                names.add(p[1])
        return sorted(names)
