"""The legacy ``.kubernetes_auth`` file (ref: pkg/clientauth/clientauth.go).

Port of ``kubernetes_tpu/client/clientauth.py``.

A defined JSON format for API authorization config — user/password,
bearer token, TLS material — written by cluster bring-up and read by
clients in any language. Distinct from kubeconfig (client/clientcmd.py),
which holds general CLI preferences; this file is authorization only,
and its values merge INTO a transport configuration
(ref: clientauth.go:104 MergeWithConfig).

Example:

    info = clientauth.load_from_file(os.path.expanduser("~/.kubernetes_auth"))
    transport = HTTPTransport("https://master:6443", **info.transport_kwargs())
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["Info", "load_from_file"]


@dataclass
class Info:
    """ref: clientauth.go:76 authcfg.Info — field-for-field."""

    user: str = ""
    password: str = ""
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    bearer_token: str = ""
    insecure: Optional[bool] = None

    def complete(self) -> bool:
        """ref: clientauth.go:121 Complete — enough material to auth."""
        return bool(self.user or self.cert_file or self.bearer_token)

    def transport_kwargs(self) -> dict:
        """Merge into HTTPTransport keyword arguments
        (ref: clientauth.go:104 MergeWithConfig)."""
        kw: dict = {}
        if self.bearer_token:
            kw["auth"] = ("bearer", self.bearer_token)
        elif self.user:
            kw["auth"] = ("basic", self.user, self.password)
        if self.ca_file:
            kw["ca_cert"] = self.ca_file
        if self.cert_file:
            kw["client_cert"] = self.cert_file
        if self.key_file:
            kw["client_key"] = self.key_file
        if self.insecure is not None:
            kw["insecure_skip_tls_verify"] = self.insecure
        return kw


_WIRE = {"User": "user", "Password": "password", "CAFile": "ca_file",
         "CertFile": "cert_file", "KeyFile": "key_file",
         "BearerToken": "bearer_token", "Insecure": "insecure"}


def load_from_file(path: str) -> Info:
    """Parse an Info from ``path`` (ref: clientauth.go:88 LoadFromFile).
    Raises FileNotFoundError when absent, ValueError on malformed JSON."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(
            f"{path}: expected a JSON object, got {type(data).__name__}")
    info = Info()
    for wire, attr in _WIRE.items():
        if wire in data:
            setattr(info, attr, data[wire])
    return info
