"""The port's binaries on the cases of tests/test_cmd.py: flag parsing,
hyperkube's dispatch, apiserver + controller manager + scheduler +
kubelet wired over HTTP, the standalone binary and the kubelet's HTTP
manifest source. An entry point called without a device runs on the
CPU (``port_on_the_cpu``). A kubelet that stops leaves its pods running,
as a real one does; after each case the processes that a process
runtime started under the case's directory are killed. No case is left
out."""

import time

import pytest

from chip_smoke import _kill_runtime_procs
from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_cmd"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch, tmp_path):
    port_on_the_cpu(monkeypatch)
    yield
    # a stopped kubelet's last sync may still start a pod: kill until
    # none was left for a second, for at most 5 s
    deadline = time.monotonic() + 5.0
    quiet = 0.0
    while quiet < 1.0 and time.monotonic() < deadline:
        quiet = 0.0 if _kill_runtime_procs(str(tmp_path)) else quiet + 0.2
        time.sleep(0.2)


def test_standalone_tpu_batch_solves_on_the_named_device(monkeypatch):
    """``--algorithm tpu-batch --device cpu``: the in-process cluster's
    BatchScheduler gets the device through ``ClusterConfig.device`` and
    binds a pod with the kernel's plain version; without ``--device``
    its default is ``cuda``. The CPU default of ``port_on_the_cpu`` is
    undone first, so that only the flag names the CPU."""
    import time

    monkeypatch.undo()

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.cmd.standalone import (build_parser,
                                                     standalone_server)

    assert build_parser().parse_args([]).device == "cuda"
    port = free_port()
    stop, t = run_server(standalone_server,
                         ["--port", str(port), "--nodes", "1",
                          "--algorithm", "tpu-batch", "--device", "cpu"])
    try:
        client = Client(HTTPTransport(f"http://127.0.0.1:{port}"))
        client.pods().create(api.Pod(
            metadata=api.ObjectMeta(name="p0", namespace="default"),
            spec=api.PodSpec(containers=[api.Container(name="c",
                                                       image="img")])))
        deadline = time.monotonic() + 20
        while client.pods().get("p0").status.phase != api.PodRunning:
            assert time.monotonic() < deadline, "p0 never ran"
            time.sleep(0.1)
        assert client.pods().get("p0").spec.host == "node-0"
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
