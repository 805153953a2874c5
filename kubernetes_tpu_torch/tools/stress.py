"""Concurrency stress harness — the Go race detector analog.

Port of ``hack/stress.py``. The reference opts its whole test suite into
``-race`` (ref: hack/test-go.sh:50 KUBE_RACE); Python has no data-race
sanitizer, so this harness does the next best thing: it cranks the
interpreter's thread switch interval down ~1000x to maximize
interleavings, then churns every threaded component at once against one
in-process cluster of the port —

  - writer threads creating/deleting pods,
  - a node flapper adding/removing nodes,
  - a fault injector forcing watch-channel errors in the store (the
    reflectors must relist and resume, ref: fake_etcd_client.go:58-66),
  - reader threads hammering LIST/GET,

— while the scheduler (serial, or the tpu-batch wave scheduler solving on
``--device``), the controller manager and the kubelets run their loops.
At the end it drains the churn and checks that the system converged:
every surviving pod is bound, the store accepts a final write, and no
component loop counted an escaped exception (the ``*loop_errors_total``
series, read as the run's increase). How many of the bound survivors a
kubelet has reported Running by then is counted, not checked: a pod bound
to a flapped node has no kubelet to run it.

``run(...)`` does one run and returns its counts (a caller in the same
process reads the kernel's launch counter around it); ``main()`` is the
command line, which prints ``CLEAN`` when the run converged.

Usage: python -m kubernetes_tpu_torch.tools.stress [--seconds 20]
       [--writers 4] [--batch [--device cuda|cpu]] [--seed 0]
Exit code 0 = converged clean.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _REPO)

__all__ = ["run", "main"]


def _loop_errors(registry) -> dict:
    """series -> value of every ``*loop_errors_total`` sample."""
    out = {}
    for line in registry.render_text().splitlines():
        if "loop_errors_total" in line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def run(seconds: float = 20.0, writers: int = 4, batch: bool = False,
        seed: int = 0, device: str = "cuda", out=None) -> dict:
    """One stress run -> its counts: ``churned`` pods, ``survivors``,
    ``unbound`` survivor names, ``running`` (the bound survivors reported
    Running), ``loop_errors`` (the series whose count rose in this run),
    ``thread_errors``, ``switch_interval`` (restored, read after the run)
    and ``clean``.
    ``device`` is where the tpu-batch waves solve: ``cuda`` raises
    without a card before anything starts. Progress lines go to ``out``
    (stdout by default)."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.cluster import Cluster, ClusterConfig
    from kubernetes_tpu_torch.storage.memstore import StoreError
    from kubernetes_tpu_torch.util import metrics

    out = out or sys.stdout
    if batch:
        from kubernetes_tpu_torch.models.batch_solver import resolve_device
        resolve_device(device)
    registry = metrics.default_registry()
    errors_before = _loop_errors(registry)
    cluster = Cluster(ClusterConfig(
        num_nodes=3, node_cpu="64", node_memory="256Gi",
        rc_sync_period=0.1, kubelet_resync=0.1, node_poll_period=0.1,
        batch_scheduler=batch, device=device))
    client = cluster.client
    store = cluster.master.store
    stop = threading.Event()
    errors: list = []
    seq = [0]
    seq_lock = threading.Lock()
    threads: list = []

    def guard(fn):
        def loop():
            rng = random.Random(seed + hash(fn.__name__) % 1000)
            while not stop.is_set():
                try:
                    fn(rng)
                except StoreError:
                    pass  # injected faults surface here by design
                except Exception as e:  # noqa: BLE001
                    if "not found" in str(e).lower() or \
                            "already exists" in str(e).lower() or \
                            "conflict" in str(e).lower():
                        continue  # legitimate race outcomes
                    errors.append((fn.__name__, repr(e)))
        t = threading.Thread(target=loop, daemon=True, name=fn.__name__)
        t.start()
        return t

    def writer(rng):
        with seq_lock:
            seq[0] += 1
            i = seq[0]
        name = f"stress-{i:06d}"
        client.pods().create(api.Pod(
            metadata=api.ObjectMeta(name=name, namespace="default"),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(limits={
                    "cpu": Quantity("10m"), "memory": Quantity("16Mi")}))])))
        time.sleep(rng.uniform(0, 0.01))
        if rng.random() < 0.5:
            client.pods().delete(name)

    def node_flapper(rng):
        time.sleep(rng.uniform(0.2, 0.5))
        name = f"flappy-{rng.randint(0, 2)}"
        try:
            client.nodes().delete(name)
        except Exception:
            client.nodes().create(api.Node(
                metadata=api.ObjectMeta(name=name),
                spec=api.NodeSpec(capacity={"cpu": Quantity("4"),
                                            "memory": Quantity("8Gi")})))

    def fault_injector(rng):
        time.sleep(rng.uniform(0.3, 0.8))
        # close a live watch channel mid-stream: reflectors must relist
        store.inject_error("watch", "/registry/pods",
                           StoreError("injected watch failure"))

    def reader(rng):
        client.pods().list()
        client.nodes().list()
        time.sleep(rng.uniform(0, 0.005))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # ~1000x more thread interleavings
    try:
        cluster.start()
        threads += [guard(writer) for _ in range(writers)]
        threads += [guard(node_flapper), guard(fault_injector),
                    guard(reader), guard(reader)]
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            time.sleep(0.25)
        stop.set()
        for t in threads:
            t.join(timeout=5)

        # -- convergence: drain and verify ---------------------------------
        deadline = time.monotonic() + 30
        pods: list = []
        while time.monotonic() < deadline:
            pods = [p for p in client.pods().list().items
                    if not p.metadata.name.startswith("flappy")]
            if pods and all(p.spec.host for p in pods):
                break
            time.sleep(0.2)
        unbound = [p.metadata.name for p in pods if not p.spec.host]
        running = sum(1 for p in pods if p.spec.host
                      and p.status.phase == api.PodRunning)
        # the store still accepts writes
        client.pods().create(api.Pod(
            metadata=api.ObjectMeta(name="post-stress", namespace="default"),
            spec=api.PodSpec(containers=[api.Container(name="c",
                                                       image="img")])))
        # no exception escaped any component loop in this run
        loop_errors = {s: v - errors_before.get(s, 0.0)
                       for s, v in _loop_errors(registry).items()
                       if v > errors_before.get(s, 0.0)}
    finally:
        stop.set()
        cluster.stop()
        sys.setswitchinterval(interval)
    for t in threads:
        t.join(timeout=5)
    result = {"churned": seq[0], "survivors": len(pods),
              "unbound": unbound, "running": running,
              "loop_errors": loop_errors, "thread_errors": errors,
              "switch_interval": sys.getswitchinterval()}
    result["clean"] = not (unbound or loop_errors or errors)
    if unbound:
        print(f"FAIL: {len(unbound)} pods never bound: {unbound[:5]}",
              file=out)
    for series, n in loop_errors.items():
        print(f"FAIL: component loop errors: {series} +{n:g}", file=out)
    if errors:
        print(f"FAIL: {len(errors)} unexpected thread errors: {errors[:5]}",
              file=out)
    print(f"stress: {seq[0]} pods churned over {seconds:.0f}s; "
          f"{len(pods)} survivors all bound ({running} Running); "
          f"{'CLEAN' if result['clean'] else 'FAILURES ABOVE'}", file=out)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stress")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--writers", type=int, default=4)
    ap.add_argument("--batch", action="store_true",
                    help="tpu-batch wave scheduler instead of serial")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="--batch: where each wave solves (cuda raises "
                         "without a card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    result = run(args.seconds, args.writers, args.batch, args.seed,
                 args.device)
    # skip Py_Finalize: with the switch interval cranked to 10us, daemon
    # threads parked inside native waits intermittently abort CPython
    # teardown AFTER the verdict above — the standard hard exit for
    # thread-heavy harnesses
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if result["clean"] else 1)


if __name__ == "__main__":
    sys.exit(main())
