"""Authentication: user info + request authenticators.

Port of ``kubernetes_tpu/auth/__init__.py``.

Rebuild of ``pkg/auth/user`` and the request authenticators in
``plugin/pkg/auth/authenticator/request/`` (basicauth, bearertoken +
tokenfile, x509, union). Authenticators consume a parsed request descriptor
(headers + optional TLS peer certificate) instead of an ``http.Request`` and
return ``(UserInfo, ok)`` like the reference's
``authenticator.Request.AuthenticateRequest``.
"""

from __future__ import annotations

import base64
import csv
import io
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = ["UserInfo", "AuthRequest", "BasicAuthAuthenticator",
           "TokenAuthenticator", "load_token_file", "X509Authenticator",
           "UnionAuthenticator", "PasswordFile", "load_password_file"]


@dataclass(frozen=True)
class UserInfo:
    """ref: pkg/auth/user/user.go DefaultInfo."""

    name: str
    uid: str = ""
    groups: Tuple[str, ...] = ()

    def get_name(self) -> str:
        return self.name


@dataclass
class AuthRequest:
    """The slice of an HTTP request that authenticators look at."""

    headers: Mapping[str, str] = field(default_factory=dict)
    # ssl.getpeercert()-shaped dict, when the server runs TLS with client auth
    peer_cert: Optional[dict] = None

    def header(self, name: str) -> str:
        for k, v in self.headers.items():
            if k.lower() == name.lower():
                return v
        return ""


class PasswordFile:
    """ref: plugin/pkg/auth/authenticator/password/passwordfile — CSV rows
    ``password,username,uid``."""

    def __init__(self, users: Dict[str, Tuple[str, str]]):
        self.users = users  # name -> (password, uid)

    def authenticate(self, username: str, password: str) -> Optional[UserInfo]:
        entry = self.users.get(username)
        if entry is None or entry[0] != password:
            return None
        return UserInfo(name=username, uid=entry[1])


def load_password_file(text: str) -> PasswordFile:
    users: Dict[str, Tuple[str, str]] = {}
    for row in csv.reader(io.StringIO(text)):
        if len(row) >= 3:
            users[row[1].strip()] = (row[0].strip(), row[2].strip())
    return PasswordFile(users)


class BasicAuthAuthenticator:
    """ref: plugin/pkg/auth/authenticator/request/basicauth/basicauth.go."""

    def __init__(self, password_auth: PasswordFile):
        self.password_auth = password_auth

    def authenticate(self, req: AuthRequest) -> Tuple[Optional[UserInfo], bool]:
        hdr = req.header("Authorization")
        if not hdr.startswith("Basic "):
            return None, False
        try:
            raw = base64.b64decode(hdr[len("Basic "):]).decode("utf-8")
            username, _, password = raw.partition(":")
        except Exception:
            return None, False
        info = self.password_auth.authenticate(username, password)
        return (info, info is not None)


class TokenAuthenticator:
    """Bearer tokens against a static table
    (ref: request/bearertoken + token/tokenfile: CSV ``token,user,uid``)."""

    def __init__(self, tokens: Dict[str, UserInfo]):
        self.tokens = tokens

    def authenticate(self, req: AuthRequest) -> Tuple[Optional[UserInfo], bool]:
        hdr = req.header("Authorization")
        if not hdr.startswith("Bearer "):
            return None, False
        info = self.tokens.get(hdr[len("Bearer "):].strip())
        return (info, info is not None)


def load_token_file(text: str) -> TokenAuthenticator:
    """token,user,uid[,\"group1,group2\"] per line (ref: the tokenfile
    authenticator's CSV shape, plugin/pkg/auth/authenticator/token/
    tokenfile — the optional fourth column carries group memberships)."""
    tokens: Dict[str, UserInfo] = {}
    for row in csv.reader(io.StringIO(text)):
        if len(row) >= 3:
            groups = tuple(g.strip() for g in row[3].split(",") if g.strip()) \
                if len(row) >= 4 else ()
            tokens[row[0].strip()] = UserInfo(
                name=row[1].strip(), uid=row[2].strip(), groups=groups)
    return TokenAuthenticator(tokens)


class X509Authenticator:
    """Client-certificate CommonName auth
    (ref: request/x509/x509.go CommonNameUserConversion)."""

    def authenticate(self, req: AuthRequest) -> Tuple[Optional[UserInfo], bool]:
        cert = req.peer_cert
        if not cert:
            return None, False
        for rdn in cert.get("subject", ()):
            for key, value in rdn:
                if key == "commonName" and value:
                    return UserInfo(name=value), True
        return None, False


class UnionAuthenticator:
    """First success wins (ref: request/union/union.go)."""

    def __init__(self, *authenticators):
        self.authenticators = list(authenticators)

    def authenticate(self, req: AuthRequest) -> Tuple[Optional[UserInfo], bool]:
        for a in self.authenticators:
            info, ok = a.authenticate(req)
            if ok:
                return info, True
        return None, False
