"""Algorithm providers: the named (predicate set, priority set) pairs.

Port of the provider table of ``kubernetes_tpu/scheduler/plugins.py``
(ref: algorithmprovider/defaults/defaults.go:26-72). The batch solver reads
only the plugin names, so the port keeps the names and not the serial
plugin functions.
"""

from __future__ import annotations

__all__ = ["DEFAULT_PROVIDER", "get_algorithm_provider"]

DEFAULT_PROVIDER = "DefaultProvider"

_ALGORITHM_PROVIDERS = {
    DEFAULT_PROVIDER: {
        "predicates": ["PodFitsPorts", "PodFitsResources", "NoDiskConflict",
                       "MatchNodeSelector", "HostName", "Schedulable"],
        "priorities": ["LeastRequestedPriority", "ServiceSpreadingPriority",
                       "EqualPriority"],
    },
}


def get_algorithm_provider(name: str) -> dict:
    return _ALGORITHM_PROVIDERS[name]
