"""End-to-end suite driver against a LIVE cluster over HTTP.

Port of ``hack/e2e.py`` (ref: hack/e2e.go + test/e2e/driver.go:56
RunE2ETests — the reference boots a real cluster and runs Ginkgo suites
against its public API). Nine suites — pods, replication, services,
events, secrets, watch, kubectl, guestbook and update-demo — run over
HTTP with the port's client, real ``kubectl`` processes (``python -m
kubernetes_tpu_torch.cmd.kubectl``) and a kubeconfig built by ``kubectl
config``, on the repo's ``examples/`` manifests. Point it at a running
master (any apiserver of a live cluster, the port's
``cmd.standalone --algorithm tpu-batch`` among them), or pass --up to
boot the port's all-in-one standalone cluster (3 nodes, the serial
scheduler) for the duration.

Usage:
  python -m kubernetes_tpu_torch.tools.e2e --up            # boot + run all
  python -m kubernetes_tpu_torch.tools.e2e --master http://host:8080
  python -m kubernetes_tpu_torch.tools.e2e --up --focus services

Exit code 0 iff every selected suite passed.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from kubernetes_tpu_torch.api import types as api              # noqa: E402
from kubernetes_tpu_torch.api.quantity import Quantity         # noqa: E402
from kubernetes_tpu_torch.client.client import Client          # noqa: E402
from kubernetes_tpu_torch.client.http import HTTPTransport     # noqa: E402
from kubernetes_tpu_torch.kubectl.scale import Resizer         # noqa: E402

NS = "e2e"


def wait_for(fn, timeout=60.0, interval=0.25, desc="condition"):
    # generous default: suites assert CONVERGENCE of live control loops;
    # on a loaded one-core box (e.g. the full pytest run) 30s flaked
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = fn()
            if last:
                return last
        except Exception as e:  # noqa: BLE001 — retried until deadline
            last = e
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {desc}: last={last!r}")


def mk_pod(name, labels=None, cpu="50m", ports=()):
    return api.Pod(
        metadata=api.ObjectMeta(name=name, namespace=NS,
                                labels=labels or {"e2e": name}),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img",
            ports=[api.ContainerPort(container_port=p) for p in ports],
            resources=api.ResourceRequirements(limits={
                "cpu": Quantity(cpu), "memory": Quantity("32Mi")}))]))


# -- suites (each: name, fn(client, master_url)) ----------------------------

def suite_pods(c: Client, master: str):
    pods = c.pods(NS)
    pods.create(mk_pod("e2e-pod"))
    wait_for(lambda: (pods.get("e2e-pod").status.phase == "Running"
                      and pods.get("e2e-pod").spec.host),
             desc="pod scheduled and running")
    pods.delete("e2e-pod")
    wait_for(lambda: all(p.metadata.name != "e2e-pod"
                         for p in pods.list().items),
             desc="pod deleted")


def suite_replication(c: Client, master: str):
    rcs = c.replication_controllers(NS)
    rcs.create(api.ReplicationController(
        metadata=api.ObjectMeta(name="e2e-rc", namespace=NS),
        spec=api.ReplicationControllerSpec(
            replicas=3, selector={"app": "e2e-rc"},
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels={"app": "e2e-rc"}),
                spec=mk_pod("t", labels={"app": "e2e-rc"}).spec))))

    def running():
        items = [p for p in c.pods(NS).list("app=e2e-rc").items
                 if p.status.phase == "Running"]
        return len(items) == 3
    wait_for(running, desc="3 replicas running")
    # kubectl's Resizer reads the RC again after a 409: the manager writes
    # the RC's status after its deletes, which can land between a bare
    # read and update (the reference's driver updates bare)
    Resizer(c).resize(NS, "e2e-rc", 1)
    wait_for(lambda: len([p for p in c.pods(NS).list("app=e2e-rc").items
                          if p.status.phase == "Running"]) == 1,
             desc="resize down to 1")
    Resizer(c).resize(NS, "e2e-rc", 0)
    wait_for(lambda: not c.pods(NS).list("app=e2e-rc").items,
             desc="replicas drained")
    rcs.delete("e2e-rc")


def suite_services(c: Client, master: str):
    c.services(NS).create(api.Service(
        metadata=api.ObjectMeta(name="e2e-svc", namespace=NS),
        spec=api.ServiceSpec(port=80, selector={"app": "e2e-svc"})))
    c.pods(NS).create(mk_pod("e2e-svc-pod", labels={"app": "e2e-svc"},
                             ports=(80,)))
    wait_for(lambda: c.pods(NS).get("e2e-svc-pod").status.phase == "Running",
             desc="backend running")

    def has_endpoints():
        for ep in c.endpoints(NS).list().items:
            if ep.metadata.name == "e2e-svc" and ep.endpoints:
                return True
        return False
    wait_for(has_endpoints, desc="endpoints populated")
    svc = c.services(NS).get("e2e-svc")
    assert svc.spec.portal_ip, "portal IP allocated"
    c.pods(NS).delete("e2e-svc-pod")
    c.services(NS).delete("e2e-svc")


def suite_events(c: Client, master: str):
    c.pods(NS).create(mk_pod("e2e-ev"))
    wait_for(lambda: c.pods(NS).get("e2e-ev").status.phase == "Running",
             desc="pod running")

    def has_sched_event():
        for ev in c.events(NS).list().items:
            if (ev.involved_object.name == "e2e-ev"
                    and ev.reason in ("Scheduled", "scheduled")):
                return True
        return False
    wait_for(has_sched_event, desc="Scheduled event recorded")
    c.pods(NS).delete("e2e-ev")


def suite_secrets(c: Client, master: str):
    c.secrets(NS).create(api.Secret(
        metadata=api.ObjectMeta(name="e2e-secret", namespace=NS),
        data={"token": "aGVsbG8="}))
    got = c.secrets(NS).get("e2e-secret")
    assert got.data["token"] == "aGVsbG8="
    c.secrets(NS).delete("e2e-secret")


def make_kubectl(master: str, ctx: str):
    """A real-kubectl runner bound to a fresh kubeconfig built through
    the `kubectl config` verbs, like a user would. Returns (kubectl,
    cleanup); kubectl(*args, check=True) runs the CLI subprocess."""
    import tempfile
    kubeconfig = tempfile.mktemp(suffix=".kubeconfig")
    env = dict(os.environ, KUBECONFIG=kubeconfig,
               PYTHONPATH=REPO + (os.pathsep + os.environ["PYTHONPATH"]
                                  if os.environ.get("PYTHONPATH") else ""))

    def kubectl(*args, check=True, timeout=60):
        out = subprocess.run(
            [sys.executable, "-m", "kubernetes_tpu_torch.cmd.kubectl",
             *args],
            capture_output=True, text=True, env=env, timeout=timeout)
        if check:
            assert out.returncode == 0, f"kubectl {args}: {out.stderr}"
        return out

    def cleanup():
        if os.path.exists(kubeconfig):
            os.unlink(kubeconfig)

    try:
        for args in (("config", "set-cluster", ctx, f"--server={master}"),
                     ("config", "set-context", ctx, f"--cluster={ctx}"),
                     ("config", "use-context", ctx)):
            kubectl(*args)
    except BaseException:
        cleanup()
        raise
    return kubectl, cleanup


def suite_kubectl(c: Client, master: str):
    # the CLI finds the server via kubeconfig, like the reference —
    # build one with the real `kubectl config` verbs
    kubectl, cleanup = make_kubectl(master, "e2e")
    try:
        out = kubectl("get", "nodes")
        assert "node" in out.stdout.lower(), out.stdout
        out = kubectl("-n", NS, "get", "pods", "-o", "json")
        json.loads(out.stdout)
    finally:
        cleanup()


def suite_watch(c: Client, master: str):
    """Chunked-JSON watch over real HTTP delivers an ADDED event."""
    w = c.pods(NS).watch()
    try:
        c.pods(NS).create(mk_pod("e2e-watch"))
        deadline = time.monotonic() + 15
        while True:
            # Bounded read: a silent stream must still trip the deadline
            # (a bare `for ev in w` would block forever on an empty queue).
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise AssertionError("no ADDED event over HTTP watch")
            try:
                ev = w.next_event(timeout=min(remaining, 1.0))
            except queue.Empty:
                continue
            if ev is None:
                raise AssertionError("watch stream ended before ADDED event")
            if (ev.type == "ADDED"
                    and getattr(ev.object.metadata, "name", "") == "e2e-watch"):
                break
    finally:
        w.stop()
        c.pods(NS).delete("e2e-watch")


def suite_guestbook(c: Client, master: str):
    """The examples/guestbook walkthrough, executed exactly as the README
    tells a user to: every step through the real kubectl binary with
    `create -f` on the checked-in manifest files
    (ref: examples/guestbook/README.md in the reference)."""
    gb = os.path.join(REPO, "examples", "guestbook")
    run_kubectl, cleanup = make_kubectl(master, "gb")

    def kubectl(*args):
        return run_kubectl(*args).stdout

    pods = c.pods("default")
    try:
        # 1-3: master, slaves, frontend — controllers then services
        for m in ("redis-master-controller", "redis-master-service",
                  "redis-slave-controller", "redis-slave-service",
                  "frontend-controller", "frontend-service"):
            kubectl("create", "-f", os.path.join(gb, m + ".json"))

        def tier_running(selector, n):
            items = [p for p in pods.list(selector).items
                     if p.status.phase == "Running" and p.spec.host]
            return len(items) == n
        wait_for(lambda: tier_running("name=redis-master", 1),
                 desc="redis master running")
        wait_for(lambda: tier_running("name=redis-slave", 2),
                 desc="2 redis slaves running")
        wait_for(lambda: tier_running("name=frontend", 3),
                 desc="3 frontends running")

        # endpoints follow the pods (the endpoints controller's job)
        def master_endpoints():
            ep = c.endpoints("default").get("redis-master")
            return len(ep.endpoints or []) == 1
        wait_for(master_endpoints, desc="redis-master endpoints")

        # transcript step 4: resize the frontend
        kubectl("resize", "rc", "frontend", "--replicas=5")
        wait_for(lambda: tier_running("name=frontend", 5),
                 desc="frontend resized to 5")

        # the CLI sees what the README claims it sees
        out = kubectl("get", "rc")
        assert "frontend" in out and "redis-master" in out, out
        out = kubectl("get", "pods", "-l", "app=guestbook")
        assert out.count("Running") >= 5, out
    finally:
        # transcript step 5: teardown (best-effort: check=False)
        for rc_name in ("frontend", "redis-slave", "redis-master"):
            run_kubectl("stop", "rc", rc_name, check=False, timeout=120)
            run_kubectl("delete", "services", rc_name, check=False)
        cleanup()
    wait_for(lambda: not pods.list("app=redis").items
             and not pods.list("app=guestbook").items,
             desc="guestbook drained")


def suite_update_demo(c: Client, master: str):
    """The examples/update-demo walkthrough: create the nautilus RC, roll
    it to kitten with the real `kubectl rollingupdate` against the live
    stack, sampling the availability invariant the demo exists to show —
    the combined name=update-demo group keeps at least desired-1 pods at
    every instant of the roll (one replica in flight at a time; ref:
    examples/update-demo/README.md in the reference;
    pkg/kubectl/rolling_updater.go)."""
    ud = os.path.join(REPO, "examples", "update-demo")
    run_kubectl, cleanup = make_kubectl(master, "ud")
    pods = c.pods("default")

    def running(selector):
        return [p for p in pods.list(selector).items
                if p.status.phase == "Running" and p.spec.host]
    try:
        run_kubectl("create", "-f", os.path.join(ud, "nautilus-rc.json"))
        wait_for(lambda: len(running("version=nautilus")) == 2,
                 desc="2 nautilus pods running")

        # sample the availability invariant WHILE the roll runs: one
        # replica moves at a time, so the combined group never drops
        # below desired-1 pods (2 replicas -> floor 1)
        import threading
        floor_violations = []
        stop_sampling = threading.Event()

        def sample():
            while not stop_sampling.is_set():
                try:
                    n = len(pods.list("name=update-demo").items)
                    if n < 1:
                        floor_violations.append(n)
                except Exception:
                    pass
                time.sleep(0.1)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        try:
            out = run_kubectl("rollingupdate", "update-demo-nautilus",
                              "-f", os.path.join(ud, "kitten-rc.json"),
                              "--timeout=120", timeout=150)
        finally:
            stop_sampling.set()
            sampler.join(timeout=5)
        assert "update-demo-kitten" in out.stdout, out.stdout
        assert not floor_violations, \
            f"group dropped below desired-1 pods mid-roll: {floor_violations}"

        wait_for(lambda: len(running("version=kitten")) == 2,
                 desc="2 kitten pods running")
        # the old controller is gone, the new one owns the group
        names = [rc.metadata.name
                 for rc in c.replication_controllers("default").list().items]
        assert "update-demo-nautilus" not in names, names
        assert "update-demo-kitten" in names, names
        assert not running("version=nautilus"), "nautilus pods survived roll"

        # transcript step 3: the rolled group is an ordinary rc
        run_kubectl("resize", "rc", "update-demo-kitten", "--replicas=4")
        wait_for(lambda: len(running("version=kitten")) == 4,
                 desc="kitten resized to 4")
    finally:
        run_kubectl("stop", "rc", "update-demo-kitten",
                    check=False, timeout=120)
        run_kubectl("stop", "rc", "update-demo-nautilus",
                    check=False, timeout=120)
        cleanup()
    wait_for(lambda: not pods.list("name=update-demo").items,
             desc="update-demo drained")


SUITES = [
    ("pods", suite_pods),
    ("replication", suite_replication),
    ("services", suite_services),
    ("events", suite_events),
    ("secrets", suite_secrets),
    ("watch", suite_watch),
    ("kubectl", suite_kubectl),
    ("guestbook", suite_guestbook),
    ("update-demo", suite_update_demo),
]


def main(argv=None, timings=None) -> int:
    """Run the selected suites; with ``timings`` (a dict), each suite
    that passed leaves its seconds there under its name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--master", default="http://127.0.0.1:8080")
    ap.add_argument("--up", action="store_true",
                    help="boot the all-in-one standalone cluster first")
    ap.add_argument("--port", type=int, default=18230)
    ap.add_argument("--focus", default="",
                    help="substring filter on suite names")
    args = ap.parse_args(argv)

    proc = None
    master = args.master
    try:
        if args.up:
            master = f"http://127.0.0.1:{args.port}"
            env = dict(os.environ, PYTHONPATH=REPO + (
                os.pathsep + os.environ["PYTHONPATH"]
                if os.environ.get("PYTHONPATH") else ""))
            proc = subprocess.Popen(
                [sys.executable, "-m", "kubernetes_tpu_torch.cmd.standalone",
                 "--port", str(args.port), "--nodes", "3"],
                env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            wait_for(lambda: urllib.request.urlopen(
                f"{master}/healthz", timeout=1).status == 200,
                timeout=60, desc="standalone cluster healthy")
        return _run_suites(master, args.focus, timings)
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _run_suites(master: str, focus: str, timings) -> int:
    client = Client(HTTPTransport(master))
    try:
        client.namespaces().create(api.Namespace(
            metadata=api.ObjectMeta(name=NS)))
    except Exception:
        pass  # already exists

    selected = [(n, f) for n, f in SUITES if not focus or focus in n]
    if not selected:
        print(f"error: --focus {focus!r} matches no suite "
              f"(have: {', '.join(n for n, _ in SUITES)})")
        return 2

    failed = []
    for name, fn in selected:
        t0 = time.perf_counter()
        try:
            fn(client, master)
            dt = time.perf_counter() - t0
            if timings is not None:
                timings[name] = dt
            print(f"ok   {name}  ({dt:.1f}s)")
        except Exception as e:  # noqa: BLE001 — suite verdict
            failed.append(name)
            print(f"FAIL {name}: {e}")
    print(f"\n{'FAILED: ' + ', '.join(failed) if failed else 'ALL SUITES PASSED'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
