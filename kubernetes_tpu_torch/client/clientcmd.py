"""kubeconfig loading and merging (ref: pkg/client/clientcmd/ +
docs/kubeconfig-file.md).

Port of ``kubernetes_tpu/client/clientcmd.py``.

The kubeconfig file format holds named clusters, users (auth info) and
contexts (cluster+user+namespace triples), plus ``current-context``.
Multiple files merge left-to-right with earlier files winning per key,
matching the reference's load order: --kubeconfig flag, $KUBECONFIG (a
path list), then ~/.kube/config.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import yaml

__all__ = ["Cluster", "AuthInfo", "Context", "KubeConfig", "load_config", "load_file",
           "client_from_config", "ConfigError"]


class ConfigError(Exception):
    pass


@dataclass
class Cluster:
    """ref: clientcmd/api/types.go Cluster."""

    server: str = ""
    api_version: str = ""
    insecure_skip_tls_verify: bool = False
    certificate_authority: str = ""


@dataclass
class AuthInfo:
    """ref: clientcmd/api/types.go AuthInfo."""

    token: str = ""
    username: str = ""
    password: str = ""
    client_certificate: str = ""
    client_key: str = ""


@dataclass
class Context:
    """ref: clientcmd/api/types.go Context."""

    cluster: str = ""
    user: str = ""
    namespace: str = ""


@dataclass
class KubeConfig:
    """ref: clientcmd/api/types.go Config."""

    clusters: Dict[str, Cluster] = field(default_factory=dict)
    users: Dict[str, AuthInfo] = field(default_factory=dict)
    contexts: Dict[str, Context] = field(default_factory=dict)
    current_context: str = ""

    def merge(self, other: "KubeConfig") -> "KubeConfig":
        """Earlier (self) wins per key (ref: loader.go mergeConfig)."""
        for name, c in other.clusters.items():
            self.clusters.setdefault(name, c)
        for name, u in other.users.items():
            self.users.setdefault(name, u)
        for name, ctx in other.contexts.items():
            self.contexts.setdefault(name, ctx)
        if not self.current_context:
            self.current_context = other.current_context
        return self

    def resolve(self, context_name: str = "") -> tuple:
        """-> (Cluster, AuthInfo, namespace) for a context."""
        name = context_name or self.current_context
        if not name:
            raise ConfigError("no context chosen and no current-context set")
        ctx = self.contexts.get(name)
        if ctx is None:
            raise ConfigError(f"context {name!r} not found")
        cluster = self.clusters.get(ctx.cluster)
        if cluster is None:
            raise ConfigError(f"cluster {ctx.cluster!r} not found")
        user = self.users.get(ctx.user, AuthInfo())
        return cluster, user, ctx.namespace or "default"

    # -- (de)serialization -------------------------------------------------
    @classmethod
    def from_wire(cls, data: dict) -> "KubeConfig":
        cfg = cls()
        for entry in data.get("clusters", []):
            c = entry.get("cluster", {})
            cfg.clusters[entry["name"]] = Cluster(
                server=c.get("server", ""),
                api_version=c.get("api-version", ""),
                insecure_skip_tls_verify=c.get("insecure-skip-tls-verify", False),
                certificate_authority=c.get("certificate-authority", ""))
        for entry in data.get("users", []):
            u = entry.get("user", {})
            cfg.users[entry["name"]] = AuthInfo(
                token=u.get("token", ""),
                username=u.get("username", ""),
                password=u.get("password", ""),
                client_certificate=u.get("client-certificate", ""),
                client_key=u.get("client-key", ""))
        for entry in data.get("contexts", []):
            c = entry.get("context", {})
            cfg.contexts[entry["name"]] = Context(
                cluster=c.get("cluster", ""), user=c.get("user", ""),
                namespace=c.get("namespace", ""))
        cfg.current_context = data.get("current-context", "")
        return cfg

    def to_wire(self) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Config",
            "clusters": [{"name": n, "cluster": {
                k: v for k, v in (("server", c.server),
                                  ("api-version", c.api_version),
                                  ("insecure-skip-tls-verify",
                                   c.insecure_skip_tls_verify or None),
                                  ("certificate-authority",
                                   c.certificate_authority)) if v}}
                for n, c in sorted(self.clusters.items())],
            "users": [{"name": n, "user": {
                k: v for k, v in (("token", u.token),
                                  ("username", u.username),
                                  ("password", u.password),
                                  ("client-certificate", u.client_certificate),
                                  ("client-key", u.client_key)) if v}}
                for n, u in sorted(self.users.items())],
            "contexts": [{"name": n, "context": {
                k: v for k, v in (("cluster", c.cluster), ("user", c.user),
                                  ("namespace", c.namespace)) if v}}
                for n, c in sorted(self.contexts.items())],
            "current-context": self.current_context,
        }


def load_file(path: str) -> KubeConfig:
    """Load one kubeconfig file with no merging."""
    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f.read()) or {}
    return KubeConfig.from_wire(data)


def load_config(explicit_path: str = "", env: Optional[dict] = None,
                home: str = "") -> KubeConfig:
    """Merge in precedence order (ref: clientcmd/loader.go Load):
    explicit --kubeconfig, then each path in $KUBECONFIG, then
    ~/.kube/config. Missing files are skipped (explicit path excepted)."""
    env = env if env is not None else os.environ
    paths: List[str] = []
    if explicit_path:
        if not os.path.exists(explicit_path):
            raise ConfigError(f"kubeconfig {explicit_path!r} does not exist")
        paths.append(explicit_path)
    for p in env.get("KUBECONFIG", "").split(os.pathsep):
        if p:
            paths.append(p)
    home = home or os.path.expanduser("~")
    paths.append(os.path.join(home, ".kube", "config"))
    cfg = KubeConfig()
    for p in paths:
        if os.path.exists(p):
            cfg.merge(load_file(p))
    return cfg


def client_from_config(explicit_path: str = "", context: str = "",
                       env: Optional[dict] = None):
    """Build an HTTP Client from kubeconfig (ref: clientcmd ClientConfig)."""
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport

    cfg = load_config(explicit_path, env=env)
    cluster, user, _ns = cfg.resolve(context)
    if not cluster.server:
        raise ConfigError("cluster has no server address")
    auth = None
    if user.token:
        auth = ("bearer", user.token)
    elif user.username:
        auth = ("basic", user.username, user.password)
    kw = dict(auth=auth,
              ca_cert=cluster.certificate_authority,
              client_cert=user.client_certificate,
              client_key=user.client_key,
              insecure_skip_tls_verify=cluster.insecure_skip_tls_verify)
    if auth is None and not user.client_certificate:
        # legacy ~/.kubernetes_auth fallback (ref: pkg/clientauth) — the
        # pre-kubeconfig authorization file cluster bring-up wrote
        from kubernetes_tpu_torch.client.clientauth import load_from_file
        environ = env if env is not None else os.environ
        legacy = environ.get(
            "KUBERNETES_AUTH_PATH",
            os.path.join(os.path.expanduser("~"), ".kubernetes_auth"))
        try:
            info = load_from_file(legacy)
            if info.complete():
                kw.update(info.transport_kwargs())
        except (OSError, ValueError):
            # absent, unreadable, or malformed: proceed unauthenticated,
            # exactly as if the legacy file did not exist
            pass
    return Client(HTTPTransport(cluster.server, **kw))
