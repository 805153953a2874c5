"""API status errors (ref: pkg/api/errors/errors.go).

Port of the part of ``kubernetes_tpu/api/errors.py`` the client, the
client cache and the scheduler's error handler read: ``StatusError``
carrying an ``api.Status`` (``from_status`` for one decoded off the
wire), the 404 and 409 constructors, and the 404 and 410 predicates.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api import types as api

__all__ = ["StatusError", "new_not_found", "new_conflict",
           "is_resource_expired", "from_status", "is_not_found"]


class StatusError(Exception):
    """An error that is also an api.Status (ref: errors.go StatusError)."""

    def __init__(self, status: api.Status):
        super().__init__(status.message)
        self.status = status

    @property
    def reason(self) -> str:
        return self.status.reason

    @property
    def code(self) -> int:
        return self.status.code


def _status(code: int, reason: str, message: str, details=None):
    return StatusError(api.Status(status=api.StatusFailure, code=code,
                                  reason=reason, message=message,
                                  details=details))


def new_not_found(kind: str, name: str) -> StatusError:
    return _status(404, api.ReasonNotFound, f'{kind} "{name}" not found',
                   api.StatusDetails(name=name, kind=kind))


def new_conflict(kind: str, name: str, message: str = "") -> StatusError:
    return _status(409, api.ReasonConflict, message or (
        f'{kind} "{name}" cannot be updated: the object has been modified'),
        api.StatusDetails(name=name, kind=kind))


def is_resource_expired(e: BaseException) -> bool:
    """410 Gone — the requested resourceVersion fell out of the watch
    window (ref: errors.go NewResourceExpired); the reflector relists."""
    return isinstance(e, StatusError) and e.reason == api.ReasonExpired


def from_status(status: api.Status) -> StatusError:
    """The error a decoded failure Status stands for (ref: restclient.go
    transformResponse)."""
    return StatusError(status)


def is_not_found(e: BaseException) -> bool:
    return isinstance(e, StatusError) and e.reason == api.ReasonNotFound
