"""Version stamping (ref: pkg/version/ — git-derived build info served at
/version by the apiserver and printed by `ktpu version`).

Port of ``kubernetes_tpu/version/__init__.py``.
"""

from __future__ import annotations

import platform
from dataclasses import dataclass

__all__ = ["Info", "get"]

MAJOR = "0"
MINOR = "1"
GIT_VERSION = "v0.1.0-tpu"


@dataclass(frozen=True)
class Info:
    """ref: pkg/version/version.go Info struct."""

    major: str
    minor: str
    git_version: str
    git_commit: str
    platform: str

    def as_dict(self) -> dict:
        return {"major": self.major, "minor": self.minor,
                "gitVersion": self.git_version, "gitCommit": self.git_commit,
                "platform": self.platform}

    def __str__(self) -> str:
        return self.git_version


def get() -> Info:
    return Info(major=MAJOR, minor=MINOR, git_version=GIT_VERSION,
                git_commit="", platform=f"{platform.system().lower()}/{platform.machine()}")
