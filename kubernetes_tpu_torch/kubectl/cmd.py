"""The kubectl command tree (ref: pkg/kubectl/cmd/cmd.go).

Port of ``kubernetes_tpu/kubectl/cmd.py``.

The reference builds a cobra tree whose commands share a ``Factory`` that
supplies the client, mapper, printers and describers (``cmd.go NewFactory``).
Here the tree is argparse subcommands over the same Factory seam, so tests
(and the hyperkube-style binaries) can inject an in-process client.

Commands (parity with pkg/kubectl/cmd/):
get, describe, create, update, delete, label, namespace, log, run-container,
expose, resize, stop, rolling-update, version, api-versions, cluster-info,
config (view/use-context/set-context — see clientcmd).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional

from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.latest import VERSIONS, scheme as default_scheme
from kubernetes_tpu_torch.api.meta import default_rest_mapper
from kubernetes_tpu_torch.kubectl import generators
from kubernetes_tpu_torch.kubectl import scale as scalepkg
from kubernetes_tpu_torch.kubectl.describe import describe as describe_obj
from kubernetes_tpu_torch.kubectl.printers import printer_for
from kubernetes_tpu_torch.kubectl.resource import Builder, ResourceError, resolve_resource
from kubernetes_tpu_torch import version as versionpkg

__all__ = ["Factory", "KubectlError", "run_kubectl", "main"]


class KubectlError(Exception):
    pass


class Factory:
    """DI seam (ref: cmd.go Factory struct: Mapper/Typer/Client/Printer...)."""

    def __init__(self, client, scheme=None, mapper=None,
                 out=None, err=None, stdin=None,
                 pod_logs: Optional[Callable[[str, str, str], str]] = None,
                 pod_exec: Optional[Callable] = None,
                 node_locator: Optional[Callable[[str], Optional[str]]] = None,
                 apiserver_url: str = ""):
        self.client = client
        self.scheme = scheme or default_scheme
        self.mapper = mapper or default_rest_mapper()
        self.out = out or sys.stdout
        self.err = err or sys.stderr
        self.stdin = stdin or sys.stdin
        self._pod_logs = pod_logs
        self._pod_exec = pod_exec
        self._node_locator = node_locator
        # base URL of the API server, for proxy/exec-over-HTTP; derived
        # from an HTTPTransport when not given explicitly
        self.apiserver_url = apiserver_url or \
            getattr(getattr(client, "transport", None), "base_url", "")

    def builder(self, ns: str = "") -> Builder:
        b = Builder(self.scheme, self.mapper)
        if ns:
            b.namespace(ns)
        return b

    def pod_logs(self, namespace: str, name: str, container: str = "") -> str:
        """Wired to the node's log endpoint by the cluster harness, or via
        the apiserver node proxy over HTTP
        (ref: kubectl/cmd/log.go fetches via apiserver /proxy/minions/...)."""
        if self._pod_logs is not None:
            return self._pod_logs(namespace, name, container)
        if self.apiserver_url:
            import urllib.request
            pod = self.client.resource("pods", namespace).get(name)
            host = pod.spec.host or pod.status.host
            if not host:
                raise KubectlError(f"pod {name} is not scheduled")
            container = container or pod.spec.containers[0].name
            url = (f"{self.apiserver_url}/api/{self.scheme.default_version}"
                   f"/proxy/nodes/{host}/containerLogs/{namespace}/{name}/"
                   f"{container}")
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.read().decode()
        raise KubectlError(
            "log: no node log source configured (requires a running "
            "cluster with kubelet read-only servers)")

    def pod_exec(self, namespace: str, name: str, container: str,
                 command) -> tuple:
        """-> (exit_code, output). ref: kubectl/cmd/exec.go — runs through
        the node's /run endpoint (the SPDY-exec slot), reached via the
        apiserver node proxy; a nonzero exit arrives as a 500 whose body is
        still the command output."""
        if self._pod_exec is not None:
            return self._pod_exec(namespace, name, container, command)
        if self.apiserver_url:
            import urllib.error
            import urllib.parse
            import urllib.request
            pod = self.client.resource("pods", namespace).get(name)
            host = pod.spec.host or pod.status.host
            if not host:
                raise KubectlError(f"pod {name} is not scheduled")
            container = container or pod.spec.containers[0].name
            qs = urllib.parse.urlencode([("cmd", c) for c in command])
            url = (f"{self.apiserver_url}/api/{self.scheme.default_version}"
                   f"/proxy/nodes/{host}/run/{namespace}/{name}/"
                   f"{container}?{qs}")
            try:
                with urllib.request.urlopen(url, timeout=30) as r:
                    return 0, r.read().decode()
            except urllib.error.HTTPError as e:
                return 1, e.read().decode()
        raise KubectlError("exec: no node exec path configured")

    def kubelet_address(self, namespace: str, pod_name: str) -> tuple:
        """-> (host, "addr:port" of its kubelet) for port-forward."""
        pod = self.client.resource("pods", namespace).get(pod_name)
        host = pod.spec.host or pod.status.host
        if not host:
            raise KubectlError(f"pod {pod_name} is not scheduled")
        if self._node_locator is not None:
            loc = self._node_locator(host)
            if loc:
                return host, loc
        raise KubectlError(
            "port-forward: no kubelet locator configured")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubectl", description="kubectl controls the cluster manager.",
        exit_on_error=False)
    p.add_argument("--namespace", "-n", default="", help="namespace scope")
    p.add_argument("--api-version", default="", help="API version for output")
    sub = p.add_subparsers(dest="command")

    def out_flags(sp):
        sp.add_argument("--output", "-o", default="",
                        help="human|json|yaml|template|jsonpath")
        sp.add_argument("--template", "-t", default="",
                        help="template string for -o template/jsonpath")
        sp.add_argument("--no-headers", action="store_true")

    sp = sub.add_parser("get", exit_on_error=False)
    sp.add_argument("args", nargs="+")
    sp.add_argument("--selector", "-l", default="")
    sp.add_argument("--all-namespaces", action="store_true")
    sp.add_argument("--watch", "-w", action="store_true")
    out_flags(sp)

    sp = sub.add_parser("describe", exit_on_error=False)
    sp.add_argument("args", nargs=2, metavar=("RESOURCE", "NAME"))

    for verb in ("create", "update"):
        sp = sub.add_parser(verb, exit_on_error=False)
        sp.add_argument("--filename", "-f", action="append", required=True)

    sp = sub.add_parser("delete", exit_on_error=False)
    sp.add_argument("args", nargs="*")
    sp.add_argument("--filename", "-f", action="append", default=[])
    sp.add_argument("--selector", "-l", default="")

    sp = sub.add_parser("label", exit_on_error=False)
    sp.add_argument("args", nargs="+",
                    help="RESOURCE NAME KEY_1=VAL_1 ... KEY_N=VAL_N or KEY-")
    sp.add_argument("--overwrite", action="store_true")
    out_flags(sp)

    sp = sub.add_parser("namespace", exit_on_error=False)
    sp.add_argument("ns", nargs="?", default="")

    sp = sub.add_parser("log", exit_on_error=False)
    sp.add_argument("pod")
    sp.add_argument("container", nargs="?", default="")

    sp = sub.add_parser("run-container", aliases=["run"], exit_on_error=False)
    sp.add_argument("name")
    sp.add_argument("--image", required=True)
    sp.add_argument("--replicas", "-r", type=int, default=1)
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--labels", "-l", default="")
    sp.add_argument("--dry-run", action="store_true")
    sp.add_argument("--overrides", default="")
    out_flags(sp)

    sp = sub.add_parser("expose", exit_on_error=False)
    sp.add_argument("name")
    sp.add_argument("--port", type=int, required=True)
    sp.add_argument("--selector", default="")
    sp.add_argument("--service-name", default="")
    sp.add_argument("--container-port", "--target-port", type=int, default=0)
    sp.add_argument("--protocol", default="TCP")
    sp.add_argument("--create-external-load-balancer", action="store_true")
    sp.add_argument("--public-ip", default="")
    sp.add_argument("--dry-run", action="store_true")
    out_flags(sp)

    sp = sub.add_parser("resize", aliases=["scale"], exit_on_error=False)
    sp.add_argument("args", nargs=2, metavar=("RESOURCE", "NAME"))
    sp.add_argument("--replicas", type=int, required=True)
    sp.add_argument("--current-replicas", type=int, default=-1)
    sp.add_argument("--resource-version", default="")

    sp = sub.add_parser("stop", exit_on_error=False)
    sp.add_argument("args", nargs=2, metavar=("RESOURCE", "NAME"))

    sp = sub.add_parser("rolling-update", aliases=["rollingupdate"],
                        exit_on_error=False)
    sp.add_argument("old_name")
    sp.add_argument("--filename", "-f", required=True)
    sp.add_argument("--update-period", type=float, default=0.0)
    sp.add_argument("--timeout", type=float, default=60.0)

    sp = sub.add_parser("exec", exit_on_error=False)
    sp.add_argument("--pod", "-p", default="")
    sp.add_argument("--container", "-c", default="")
    sp.add_argument("words", nargs="*",
                    help="[POD] -- COMMAND [args...] (v0 form: -p POD CMD)")

    sp = sub.add_parser("port-forward", exit_on_error=False)
    sp.add_argument("--pod", "-p", default="")
    sp.add_argument("words", nargs="+",
                    help="[POD] LOCAL_PORT:POD_PORT [...]")
    sp.add_argument("--once", action="store_true",
                    help="serve one connection then exit (tests)")

    sp = sub.add_parser("proxy", exit_on_error=False)
    sp.add_argument("--port", type=int, default=8001)
    sp.add_argument("--www", default="", help="ignored; parity flag")
    sp.add_argument("--api-prefix", default="/api")
    sp.add_argument("--once", action="store_true",
                    help="serve one request then exit (tests)")

    for verb in ("cordon", "uncordon", "drain"):
        sp = sub.add_parser(verb, exit_on_error=False)
        sp.add_argument("node")

    sub.add_parser("version", exit_on_error=False)
    sub.add_parser("api-versions", exit_on_error=False)
    sub.add_parser("cluster-info", aliases=["clusterinfo"], exit_on_error=False)

    sp = sub.add_parser("config", exit_on_error=False)
    sp.add_argument("config_args", nargs="+",
                    help="view | use-context NAME | set-cluster NAME "
                         "--server=... | set-context NAME --cluster=... "
                         "--user=... | set-credentials NAME --token=...")
    sp.add_argument("--kubeconfig", default="")
    sp.add_argument("--server", default="")
    sp.add_argument("--cluster", default="")
    sp.add_argument("--user", default="")
    sp.add_argument("--token", default="")
    sp.add_argument("--username", default="")
    sp.add_argument("--password", default="")
    return p


def _cmd_config(f: Factory, opts) -> int:
    """ref: pkg/kubectl/cmd/config/ (view/set-cluster/set-context/
    set-credentials/use-context over the kubeconfig file)."""
    import os

    import yaml as _yaml

    from kubernetes_tpu_torch.client import clientcmd

    sub = opts.config_args[0]
    path = opts.kubeconfig or os.environ.get("KUBECONFIG", "").split(os.pathsep)[0] \
        or os.path.join(os.path.expanduser("~"), ".kube", "config")
    # Mutations operate on the single target file only — merging other
    # kubeconfigs here would copy their credentials into this file.
    cfg = clientcmd.KubeConfig()
    if os.path.exists(path):
        cfg = clientcmd.load_file(path)
    if sub == "view":
        _yaml.safe_dump(cfg.to_wire(), f.out, default_flow_style=False,
                        sort_keys=False)
        return 0
    if sub == "use-context":
        if len(opts.config_args) != 2:
            raise KubectlError("usage: config use-context NAME")
        if opts.config_args[1] not in cfg.contexts:
            raise KubectlError(f"no context exists with the name "
                               f"{opts.config_args[1]!r}")
        cfg.current_context = opts.config_args[1]
    elif sub == "set-cluster":
        cfg.clusters[opts.config_args[1]] = clientcmd.Cluster(server=opts.server)
    elif sub == "set-context":
        cfg.contexts[opts.config_args[1]] = clientcmd.Context(
            cluster=opts.cluster, user=opts.user)
    elif sub == "set-credentials":
        cfg.users[opts.config_args[1]] = clientcmd.AuthInfo(
            token=opts.token, username=opts.username, password=opts.password)
    else:
        raise KubectlError(f"unknown config subcommand {sub!r}")
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        _yaml.safe_dump(cfg.to_wire(), fh, default_flow_style=False,
                        sort_keys=False)
    return 0


def _print_infos(f: Factory, infos, ns: str, output: str, template: str,
                 no_headers: bool, version: str,
                 empty_resource: str = "pods") -> None:
    printer = printer_for(output, f.scheme, template=template,
                          no_headers=no_headers, version=version)
    if output in ("", "wide"):
        # group human output by resource so each table gets one header
        by_resource: dict = {}
        for info in infos:
            by_resource.setdefault(info.resource, []).append(info)
        first = True
        for resource, group in by_resource.items():
            if not first:
                f.out.write("\n")
            first = False
            lt = f.mapper.list_type_for(resource)
            lst = lt(items=[i.obj for i in group])
            printer.print_obj(lst, f.out)
    elif not infos and output in ("json", "yaml"):
        # zero matches still produce a well-formed document (the reference
        # prints an empty versioned List, not nothing)
        try:
            lt = f.mapper.list_type_for(empty_resource) or api.PodList
        except KeyError:
            lt = api.PodList
        printer.print_obj(lt(items=[]), f.out)
    else:
        for info in infos:
            printer.print_obj(info.obj, f.out)


def _cmd_get(f: Factory, ns: str, opts) -> int:
    b = f.builder(ns).selector(opts.selector) \
        .all_namespaces(opts.all_namespaces) \
        .resource_type_or_name(*opts.args)
    infos = b.infos(f.client)
    from kubernetes_tpu_torch.kubectl.resource import resolve_resource
    empty_resource = resolve_resource(
        opts.args[0].split("/", 1)[0]) if opts.args else "pods"
    _print_infos(f, infos, ns, opts.output, opts.template,
                 opts.no_headers, opts.api_version,
                 empty_resource=empty_resource)
    if opts.watch:
        if len({i.resource for i in infos}) != 1:
            raise KubectlError("watch requires a single resource type")
        resource = infos[0].resource
        # resume from the printed list's resourceVersion so no event in the
        # list->watch gap is dropped (ref: cmd/get.go watch path)
        ns_arg = "" if opts.all_namespaces else (ns or "default")
        lst = f.client.resource(resource, ns_arg).list(
            label_selector=opts.selector)
        rv = lst.metadata.resource_version or ""
        w = f.client.resource(resource, ns_arg) \
            .watch(label_selector=opts.selector, resource_version=rv)
        printer = printer_for(opts.output, f.scheme, template=opts.template,
                              no_headers=True, version=opts.api_version)
        for ev in w:
            printer.print_obj(ev.object, f.out)
    return 0


def _cmd_create_or_update(f: Factory, ns: str, opts, update: bool) -> int:
    b = f.builder(ns).filename(*opts.filename).stdin(f.stdin)
    count = 0
    for info in b.infos():
        rc = f.client.resource(info.resource, info.namespace)
        if update:
            rc.update(info.obj)
            f.out.write(f"{info.name}\n")
        else:
            created = rc.create(info.obj)
            f.out.write(f"{created.metadata.name}\n")
        count += 1
    if count == 0:
        raise KubectlError("no objects passed to create")
    return 0


def _cmd_delete(f: Factory, ns: str, opts) -> int:
    b = f.builder(ns).selector(opts.selector)
    if opts.filename:
        b.filename(*opts.filename).stdin(f.stdin)
    if opts.args:
        b.resource_type_or_name(*opts.args)
    for info in b.infos(f.client):
        f.client.resource(info.resource, info.namespace).delete(info.name)
        f.out.write(f"{info.name}\n")
    return 0


def _cmd_label(f: Factory, ns: str, opts) -> int:
    """ref: cmd/label.go — add/remove labels with conflict detection."""
    args = opts.args
    if len(args) < 3:
        raise KubectlError("usage: label RESOURCE NAME KEY=VAL ... or KEY-")
    resource = resolve_resource(args[0], f.mapper)
    name = args[1]
    adds: dict = {}
    removes: List[str] = []
    for spec in args[2:]:
        if spec.endswith("-"):
            removes.append(spec[:-1])
        elif "=" in spec:
            k, _, v = spec.partition("=")
            adds[k] = v
        else:
            raise KubectlError(f"unknown label spec {spec!r}")
    namespaced = f.mapper.is_namespaced(resource)
    rc = f.client.resource(resource, (ns or "default") if namespaced else "")
    obj = rc.get(name)
    labels = obj.metadata.labels
    if not opts.overwrite:
        for k, v in adds.items():
            if k in labels and labels[k] != v:
                raise KubectlError(
                    f"'{k}' already has a value ({labels[k]}), and --overwrite "
                    f"is false")
    labels.update(adds)
    for k in removes:
        labels.pop(k, None)
    obj = rc.update(obj)
    if opts.output:
        printer = printer_for(opts.output, f.scheme, template=opts.template,
                              no_headers=opts.no_headers,
                              version=opts.api_version)
        printer.print_obj(obj, f.out)
    else:
        f.out.write(f"{name} labeled\n")
    return 0


def _cmd_resize(f: Factory, ns: str, opts) -> int:
    resource = resolve_resource(opts.args[0], f.mapper)
    if resource != "replicationcontrollers":
        raise KubectlError("resize is only supported for replicationcontrollers")
    precond = scalepkg.ResizePrecondition(opts.current_replicas,
                                          opts.resource_version)
    scalepkg.Resizer(f.client).resize(ns or "default", opts.args[1],
                                      opts.replicas, preconditions=precond)
    f.out.write("resized\n")
    return 0


def _cmd_stop(f: Factory, ns: str, opts) -> int:
    resource = resolve_resource(opts.args[0], f.mapper)
    reaper = scalepkg.reaper_for(resource, f.client)
    msg = reaper.stop(ns or "default", opts.args[1])
    f.out.write(msg + "\n")
    return 0


def _cmd_run(f: Factory, ns: str, opts) -> int:
    labels = generators.parse_labels(opts.labels)
    rc = generators.generate_rc(opts.name, opts.image, opts.replicas,
                                labels or None, opts.port)
    if not opts.dry_run:
        rc = f.client.resource("replicationcontrollers",
                               ns or "default").create(rc)
    printer = printer_for(opts.output, f.scheme, template=opts.template,
                          no_headers=opts.no_headers, version=opts.api_version)
    printer.print_obj(rc, f.out)
    return 0


def _cmd_expose(f: Factory, ns: str, opts) -> int:
    selector = generators.parse_labels(opts.selector)
    if not selector:
        # default to the target RC's selector (ref: cmd/expose.go)
        try:
            rc = f.client.resource("replicationcontrollers",
                                   ns or "default").get(opts.name)
            selector = dict(rc.spec.selector)
        except errors.StatusError:
            raise KubectlError(
                "--selector is required when no replication controller "
                "with that name exists")
    svc = generators.generate_service(
        opts.service_name or opts.name, selector, opts.port,
        container_port=opts.container_port, protocol=opts.protocol,
        create_external_load_balancer=opts.create_external_load_balancer,
        public_ips=[opts.public_ip] if opts.public_ip else None)
    if not opts.dry_run:
        svc = f.client.resource("services", ns or "default").create(svc)
    printer = printer_for(opts.output, f.scheme, template=opts.template,
                          no_headers=opts.no_headers, version=opts.api_version)
    printer.print_obj(svc, f.out)
    return 0


def _cmd_rolling_update(f: Factory, ns: str, opts) -> int:
    b = f.builder(ns).filename(opts.filename).stdin(f.stdin)
    infos = b.infos()
    if len(infos) != 1 or infos[0].resource != "replicationcontrollers":
        raise KubectlError(
            "rolling-update requires exactly one ReplicationController file")
    updater = scalepkg.RollingUpdater(f.client, ns or "default")
    final = updater.update(opts.old_name, infos[0].obj,
                           update_period=opts.update_period,
                           timeout=opts.timeout)
    f.out.write(f"{final.metadata.name}\n")
    return 0


def _cmd_cordon(f: Factory, opts, on: bool) -> int:
    """ref: kubectl cordon/uncordon/drain — flips ``spec.unschedulable``.

    ``drain`` is cordon plus hand-off: pods are not evicted inline (there
    is no synchronous eviction API here); the descheduler treats every
    movable pod on a cordoned node as a mandatory migration candidate and
    empties the node on its next wave.
    """
    rc = f.client.resource("nodes", "")
    node = rc.get(opts.node)
    already = bool(node.spec.unschedulable) == on
    if not already:
        node.spec.unschedulable = on
        rc.update(node)
    verb = "cordoned" if on else "uncordoned"
    f.out.write(f"node/{opts.node} {'already ' if already else ''}{verb}\n")
    if opts.command == "drain":
        f.out.write(f"node/{opts.node} draining "
                    f"(pods migrate on the next descheduler wave)\n")
    return 0


def _cmd_exec(f: Factory, ns: str, opts) -> int:
    """ref: cmd/exec.go — `exec -p POD -c CONTAINER CMD...` or
    `exec POD -- CMD...`."""
    words = list(opts.words)
    pod = opts.pod
    if not pod:
        if not words:
            raise KubectlError("exec: pod name required")
        pod = words.pop(0)
    if not words:
        raise KubectlError("exec: command required")
    code, out = f.pod_exec(ns or "default", pod, opts.container, words)
    f.out.write(out)
    return 0 if code == 0 else 1


def _cmd_port_forward(f: Factory, ns: str, opts) -> int:
    """ref: cmd/portforward.go — local listener tunneling to the pod's port
    through the kubelet's stream-upgrade endpoint."""
    import socket
    import threading

    from kubernetes_tpu_torch.util.stream import relay_bidirectional

    words = list(opts.words)
    pod = opts.pod
    if not pod:
        pod = words.pop(0)
    if not words:
        raise KubectlError("port-forward: PORT or LOCAL:POD mapping required")
    mappings = []
    for w in words:
        local_s, _, remote_s = w.partition(":")
        local_port = int(local_s)
        mappings.append((local_port, int(remote_s) if remote_s else local_port))
    host, kubelet_addr = f.kubelet_address(ns or "default", pod)
    khost, _, kport = kubelet_addr.rpartition(":")

    def tunnel(conn, pod_port) -> bool:
        backend = None
        try:
            backend = socket.create_connection((khost, int(kport)), timeout=10)
            req = (f"POST /portForward/{ns or 'default'}/{pod}?port={pod_port} "
                   f"HTTP/1.1\r\nHost: {kubelet_addr}\r\n"
                   f"Content-Length: 0\r\n\r\n").encode()
            backend.sendall(req)
            buf = b""
            while b"\r\n\r\n" not in buf:  # read the upgrade response
                chunk = backend.recv(1024)
                if not chunk:
                    f.err.write("port-forward: kubelet closed the tunnel\n")
                    return False
                buf += chunk
            status_line = buf.split(b"\r\n", 1)[0]
            if b"101" not in status_line:
                f.err.write(f"port-forward: kubelet refused the tunnel: "
                            f"{status_line.decode(errors='replace')}\n")
                return False
            extra = buf.split(b"\r\n\r\n", 1)[1]
            if extra:
                conn.sendall(extra)
            relay_bidirectional(conn, backend, idle_timeout=60.0)
            return True
        except OSError as e:
            f.err.write(f"port-forward: {e}\n")
            return False
        finally:
            conn.close()
            if backend is not None:
                backend.close()

    listeners = []
    for local_port, pod_port in mappings:
        listener = socket.socket()
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", local_port))
        listener.listen(8)
        bound = listener.getsockname()[1]
        listeners.append((listener, pod_port))
        f.out.write(f"Forwarding from 127.0.0.1:{bound} -> {pod}:{pod_port} "
                    f"(node {host})\n")
    f.out.flush()

    def serve(listener, pod_port, once_result=None):
        while True:
            try:
                conn, _addr = listener.accept()
            except OSError:
                return
            ok = tunnel(conn, pod_port)
            if once_result is not None:
                once_result.append(ok)
                return

    try:
        if opts.once:
            # serve exactly one connection on the first mapping (tests)
            result: list = []
            serve(listeners[0][0], listeners[0][1], result)
            return 0 if result and result[0] else 1
        threads = [threading.Thread(target=serve, args=(l, p), daemon=True)
                   for l, p in listeners]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        for listener, _ in listeners:
            listener.close()


def _cmd_proxy(f: Factory, opts) -> int:
    """ref: cmd/proxy.go — local HTTP proxy to the apiserver."""
    import http.server
    import urllib.error
    import urllib.request

    if not f.apiserver_url:
        raise KubectlError("proxy requires an HTTP API server connection")
    base = f.apiserver_url
    prefix = opts.api_prefix

    class H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _relay(self):
            if not self.path.startswith(prefix):
                body = b"404: only " + prefix.encode() + b" is proxied\n"
                self.send_response(404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else None
            req = urllib.request.Request(base + self.path, data=body,
                                         method=self.command)
            if body is not None:
                req.add_header("Content-Type",
                               self.headers.get("Content-Type",
                                                "application/json"))
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    payload = r.read()
                    self.send_response(r.status)
                    ctype = r.headers.get("Content-Type", "application/json")
            except urllib.error.HTTPError as e:
                payload = e.read()
                self.send_response(e.code)
                ctype = e.headers.get("Content-Type", "application/json")
            except (urllib.error.URLError, OSError) as e:
                # apiserver unreachable -> a clean 502, not a dropped socket
                payload = f"502: apiserver unreachable: {e}\n".encode()
                self.send_response(502)
                ctype = "text/plain; charset=utf-8"
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = _relay

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", opts.port), H)
    if opts.once:
        # ThreadingHTTPServer's handler threads are daemons, which
        # server_close does not join: a kubectl process would exit, and
        # drop the one request, before its thread answered it
        httpd.daemon_threads = False
    f.out.write(f"Starting to serve on 127.0.0.1:"
                f"{httpd.server_address[1]}\n")
    f.out.flush()
    try:
        if opts.once:
            httpd.timeout = 30
            httpd.handle_request()
        else:
            httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


def run_kubectl(argv: List[str], factory: Factory) -> int:
    """Parse + execute; returns a process exit code. All output goes to the
    factory's out/err streams (testable like cmd_test.go)."""
    parser = _build_parser()
    try:
        opts = parser.parse_args(argv)
    except argparse.ArgumentError as e:
        factory.err.write(f"error: {e}\n")
        return 1
    except SystemExit:
        return 1
    if not opts.command:
        parser.print_usage(factory.err)
        return 1
    ns = opts.namespace
    f = factory
    try:
        if opts.command == "get":
            return _cmd_get(f, ns, opts)
        if opts.command == "describe":
            resource = resolve_resource(opts.args[0], f.mapper)
            namespaced = f.mapper.is_namespaced(resource)
            f.out.write(describe_obj(f.client, resource,
                                     (ns or "default") if namespaced else "",
                                     opts.args[1]))
            return 0
        if opts.command == "create":
            return _cmd_create_or_update(f, ns, opts, update=False)
        if opts.command == "update":
            return _cmd_create_or_update(f, ns, opts, update=True)
        if opts.command == "delete":
            return _cmd_delete(f, ns, opts)
        if opts.command == "label":
            return _cmd_label(f, ns, opts)
        if opts.command == "namespace":
            if opts.ns:
                f.out.write(f"Using namespace {opts.ns}\n")
            else:
                f.out.write("Using namespace default\n")
            return 0
        if opts.command == "log":
            f.out.write(f.pod_logs(ns or "default", opts.pod, opts.container))
            return 0
        if opts.command == "exec":
            return _cmd_exec(f, ns, opts)
        if opts.command == "port-forward":
            return _cmd_port_forward(f, ns, opts)
        if opts.command == "proxy":
            return _cmd_proxy(f, opts)
        if opts.command in ("run-container", "run"):
            return _cmd_run(f, ns, opts)
        if opts.command == "expose":
            return _cmd_expose(f, ns, opts)
        if opts.command in ("resize", "scale"):
            return _cmd_resize(f, ns, opts)
        if opts.command == "stop":
            return _cmd_stop(f, ns, opts)
        if opts.command in ("rolling-update", "rollingupdate"):
            return _cmd_rolling_update(f, ns, opts)
        if opts.command in ("cordon", "uncordon", "drain"):
            return _cmd_cordon(f, opts, on=opts.command != "uncordon")
        if opts.command == "version":
            f.out.write(f"Client Version: {versionpkg.get()}\n")
            return 0
        if opts.command == "api-versions":
            f.out.write("Available Server Api Versions: "
                        + ", ".join(VERSIONS) + "\n")
            return 0
        if opts.command == "config":
            return _cmd_config(f, opts)
        if opts.command in ("cluster-info", "clusterinfo"):
            svcs = f.client.resource("services", "").list(
                label_selector="kubernetes.io/cluster-service=true")
            f.out.write("Kubernetes master is running\n")
            for s in svcs.items:
                f.out.write(f"  {s.metadata.name} is running at "
                            f"{s.spec.portal_ip}:{s.spec.port}\n")
            return 0
        factory.err.write(f"error: unknown command {opts.command!r}\n")
        return 1
    except (KubectlError, ResourceError, ValueError) as e:
        f.err.write(f"error: {e}\n")
        return 1
    except errors.StatusError as e:
        f.err.write(f"Error from server: {e}\n")
        return 1


class _NoClusterClient:
    """Placeholder client when no kubeconfig resolves — commands that never
    touch the server (config, version) still work; anything else gets a
    clear error instead of a traceback."""

    transport = None  # Factory introspects this attribute at construction

    def __init__(self, reason: str):
        self.reason = reason

    def resource(self, *a, **kw):
        raise KubectlError(
            f"no cluster configured: {self.reason} "
            f"(set one up with 'kubectl config set-cluster ...')")

    def __getattr__(self, name):
        raise KubectlError(
            f"no cluster configured: {self.reason} "
            f"(set one up with 'kubectl config set-cluster ...')")


def main(argv: Optional[List[str]] = None) -> int:
    """Entry point for the real binary: connects over HTTP using kubeconfig
    (ref: cmd/kubectl/kubectl.go). kubeconfig resolution is lazy-tolerant:
    `kubectl config ...` must work before any cluster is configured."""
    from kubernetes_tpu_torch.client.clientcmd import ConfigError, client_from_config
    try:
        client = client_from_config()
    except ConfigError as e:
        client = _NoClusterClient(str(e))
    return run_kubectl(argv if argv is not None else sys.argv[1:],
                       Factory(client))
