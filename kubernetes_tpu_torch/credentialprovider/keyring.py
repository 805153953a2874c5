"""Docker registry keyring (ref: pkg/credentialprovider/{config,keyring,
provider,plugins}.go).

Port of ``kubernetes_tpu/credentialprovider/keyring.py``.
"""

from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

__all__ = ["DockerConfigEntry", "DockerConfig", "DockerKeyring", "Provider",
           "FileProvider", "EnvProvider", "register_provider",
           "default_keyring"]


@dataclass
class DockerConfigEntry:
    """ref: config.go DockerConfigEntry."""

    username: str = ""
    password: str = ""
    email: str = ""

    @classmethod
    def from_wire(cls, data: dict) -> "DockerConfigEntry":
        username, password = "", ""
        auth = data.get("auth", "")
        if auth:
            try:
                decoded = base64.b64decode(auth).decode()
                username, _, password = decoded.partition(":")
            except Exception:
                pass
        return cls(username=data.get("username", username) or username,
                   password=data.get("password", password) or password,
                   email=data.get("email", ""))

    def to_wire(self) -> dict:
        auth = base64.b64encode(
            f"{self.username}:{self.password}".encode()).decode()
        return {"auth": auth, "email": self.email}


class DockerConfig(dict):
    """registry host -> DockerConfigEntry (ref: config.go DockerConfig)."""

    @classmethod
    def from_file(cls, path: str) -> "DockerConfig":
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        # both ~/.dockercfg (flat) and config.json ({"auths": {...}}) shapes
        if "auths" in data:
            data = data["auths"]
        cfg = cls()
        for host, entry in data.items():
            cfg[_normalize_host(host)] = DockerConfigEntry.from_wire(entry)
        return cfg


def _normalize_host(host: str) -> str:
    for prefix in ("https://", "http://"):
        if host.startswith(prefix):
            host = host[len(prefix):]
    return host.rstrip("/")


def _parse_image_registry(image: str) -> str:
    """"gcr.io/proj/img:tag" -> "gcr.io"; bare images -> Docker Hub
    (ref: keyring.go isDefaultRegistryMatch logic)."""
    first = image.split("/", 1)[0]
    if "." in first or ":" in first or first == "localhost":
        return first
    return "index.docker.io"


class DockerKeyring:
    """ref: keyring.go BasicDockerKeyring — longest-prefix lookup over
    registered index entries."""

    def __init__(self):
        self._index: List[Tuple[str, DockerConfigEntry]] = []

    def add(self, config: DockerConfig) -> None:
        for host, entry in config.items():
            self._index.append((host, entry))
        # longest key first so the most specific match wins
        self._index.sort(key=lambda kv: len(kv[0]), reverse=True)

    def lookup(self, image: str) -> Tuple[Optional[DockerConfigEntry], bool]:
        """image -> (entry, found) (ref: keyring.go Lookup)."""
        registry = _parse_image_registry(image)
        target = registry + "/" + image.split("/", 1)[-1] \
            if "/" in image else registry
        for host, entry in self._index:
            # segment-bounded: "gcr.io/proj" must not match
            # "gcr.io/proj-other/img" (or "gcr.i" match all of gcr.io)
            if registry == host or target == host or \
                    target.startswith(host + "/"):
                return entry, True
        return None, False


class Provider:
    """ref: provider.go DockerConfigProvider."""

    def enabled(self) -> bool:
        raise NotImplementedError

    def provide(self) -> DockerConfig:
        raise NotImplementedError


class FileProvider(Provider):
    """~/.dockercfg / config.json loader (ref: config.go search paths)."""

    def __init__(self, paths: Optional[List[str]] = None):
        home = os.path.expanduser("~")
        self.paths = paths or [
            os.path.join(home, ".dockercfg"),
            os.path.join(home, ".docker", "config.json"),
        ]

    def enabled(self) -> bool:
        return any(os.path.exists(p) for p in self.paths)

    def provide(self) -> DockerConfig:
        for p in self.paths:
            if os.path.exists(p):
                try:
                    return DockerConfig.from_file(p)
                except (OSError, ValueError):
                    continue
        return DockerConfig()


class EnvProvider(Provider):
    """REGISTRY_AUTH_<HOST>=user:password — fills the metadata-provider slot
    (ref: gce_metadata.go) with something that works anywhere."""

    PREFIX = "REGISTRY_AUTH_"

    def __init__(self, env: Optional[dict] = None):
        self.env = env if env is not None else os.environ

    def enabled(self) -> bool:
        return any(k.startswith(self.PREFIX) for k in self.env)

    def provide(self) -> DockerConfig:
        cfg = DockerConfig()
        for key, value in self.env.items():
            if not key.startswith(self.PREFIX):
                continue
            host = key[len(self.PREFIX):].lower().replace("_", ".")
            user, _, pw = value.partition(":")
            cfg[host] = DockerConfigEntry(username=user, password=pw)
        return cfg


_PROVIDERS: List[Provider] = []


def register_provider(provider: Provider) -> None:
    """ref: plugins.go RegisterCredentialProvider."""
    _PROVIDERS.append(provider)


def default_keyring(extra_providers: Optional[List[Provider]] = None
                    ) -> DockerKeyring:
    """ref: plugins.go NewDockerKeyring — union of all enabled providers."""
    keyring = DockerKeyring()
    for provider in list(_PROVIDERS) + [FileProvider(), EnvProvider()] + \
            list(extra_providers or []):
        if provider.enabled():
            keyring.add(provider.provide())
    return keyring
