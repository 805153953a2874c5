"""API status errors (ref: pkg/api/errors/errors.go).

Port of ``kubernetes_tpu/api/errors.py``.

Every API failure is represented as a ``Status`` object; these exception
classes carry one and map to HTTP status codes in the apiserver layer
(ref: pkg/apiserver/errors.go).
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api import types as api

__all__ = [
    "StatusError",
    "new_not_found",
    "new_already_exists",
    "new_conflict",
    "new_invalid",
    "new_bad_request",
    "new_unauthorized",
    "new_forbidden",
    "new_method_not_supported",
    "new_internal_error",
    "is_not_found",
    "is_already_exists",
    "is_conflict",
    "is_invalid",
    "from_status",
]


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


def _status(code: int, reason: str, message: str, details: Optional[api.StatusDetails] = None):
    return StatusError(
        api.Status(
            status=api.StatusFailure, code=code, reason=reason, message=message, details=details
        )
    )


def new_not_found(kind: str, name: str) -> StatusError:
    return _status(
        404,
        api.ReasonNotFound,
        f'{kind} "{name}" not found',
        api.StatusDetails(name=name, kind=kind),
    )


def new_already_exists(kind: str, name: str) -> StatusError:
    return _status(
        409,
        api.ReasonAlreadyExists,
        f'{kind} "{name}" already exists',
        api.StatusDetails(name=name, kind=kind),
    )


def new_conflict(kind: str, name: str, message: str = "") -> StatusError:
    return _status(
        409,
        api.ReasonConflict,
        message or f'{kind} "{name}" cannot be updated: the object has been modified',
        api.StatusDetails(name=name, kind=kind),
    )


def new_invalid(kind: str, name: str, errs) -> StatusError:
    causes = [
        api.StatusCause(reason=api.ReasonInvalid, message=str(e), field_path=getattr(e, "field", ""))
        for e in (errs or [])
    ]
    return _status(
        422,
        api.ReasonInvalid,
        f'{kind} "{name}" is invalid: ' + "; ".join(str(e) for e in (errs or [])),
        api.StatusDetails(name=name, kind=kind, causes=causes),
    )


def new_bad_request(message: str) -> StatusError:
    return _status(400, api.ReasonBadRequest, message)


def new_unauthorized(message: str = "not authorized") -> StatusError:
    return _status(401, api.ReasonUnauthorized, message)


def new_forbidden(kind: str, name: str, message: str = "") -> StatusError:
    return _status(403, api.ReasonForbidden, message or f'{kind} "{name}" is forbidden')


def new_method_not_supported(kind: str, action: str) -> StatusError:
    return _status(405, api.ReasonMethodNotAllowed, f"{action} is not supported on resources of kind {kind}")


def new_internal_error(message: str) -> StatusError:
    return _status(500, api.ReasonInternalError, message)


def new_too_many_requests(message: str = "rate limit exceeded",
                          retry_after_s: int = 0) -> StatusError:
    """ref: handlers.go RateLimit — the read-only port's 429, grown a
    ``retry_after_s`` hint (kube-fairshed): the same number the
    Retry-After header carries also rides ``details.retryAfterSeconds``
    so JSON clients that never see response headers (error bodies
    decoded through from_status) can still honor it."""
    details = api.StatusDetails(retry_after_seconds=int(retry_after_s)) \
        if retry_after_s else None
    return _status(429, api.ReasonTooManyRequests, message, details)


def new_expired(message: str) -> StatusError:
    """410 Gone — the requested resourceVersion fell out of the watch window
    (ref: errors.go NewResourceExpired); clients respond by relisting."""
    return _status(410, api.ReasonExpired, message)


def is_resource_expired(e: BaseException) -> bool:
    return isinstance(e, StatusError) and e.reason == api.ReasonExpired


def from_status(status: api.Status) -> StatusError:
    return StatusError(status)


def is_not_found(e: BaseException) -> bool:
    return isinstance(e, StatusError) and e.reason == api.ReasonNotFound


def is_already_exists(e: BaseException) -> bool:
    return isinstance(e, StatusError) and e.reason == api.ReasonAlreadyExists


def is_conflict(e: BaseException) -> bool:
    return isinstance(e, StatusError) and e.reason == api.ReasonConflict


def is_invalid(e: BaseException) -> bool:
    return isinstance(e, StatusError) and e.reason == api.ReasonInvalid
