"""Algorithm providers and the JSON scheduler Policy.

Port of the provider table and the Policy file format of
``kubernetes_tpu/scheduler/plugins.py`` (ref: algorithmprovider/defaults/
defaults.go:26-72, plugin/pkg/scheduler/api/types.go:23-103). The batch
solver reads only plugin names, weights and arguments, so the port keeps
the provider names, the Policy dataclasses and the parser, and not the
serial plugin functions.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["DEFAULT_PROVIDER", "get_algorithm_provider", "Policy",
           "PolicyPredicate", "PolicyPriority", "load_policy"]

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


@dataclass
class PolicyPredicate:
    name: str
    # argument variants (exactly one may be set, ref: api/types.go:43-57)
    service_affinity_labels: Optional[List[str]] = None
    label_presence: Optional[dict] = None  # {"labels": [...], "presence": bool}


@dataclass
class PolicyPriority:
    name: str
    weight: int = 1
    service_anti_affinity_label: Optional[str] = None
    label_preference: Optional[dict] = None  # {"label": str, "presence": bool}


@dataclass
class Policy:
    predicates: List[PolicyPredicate] = field(default_factory=list)
    priorities: List[PolicyPriority] = field(default_factory=list)


def load_policy(data: str) -> Policy:
    """Parse the JSON policy file format (ref: api/v1/types.go;
    --policy_config_file, plugin/cmd/kube-scheduler/app/server.go:104-114)."""
    raw = json.loads(data)
    policy = Policy()
    for p in raw.get("predicates", []):
        pp = PolicyPredicate(name=p["name"])
        arg = p.get("argument") or {}
        if "serviceAffinity" in arg:
            pp.service_affinity_labels = arg["serviceAffinity"].get(
                "labels", [])
        if "labelsPresence" in arg:
            pp.label_presence = {
                "labels": arg["labelsPresence"].get("labels", []),
                "presence": arg["labelsPresence"].get("presence", True),
            }
        policy.predicates.append(pp)
    for p in raw.get("priorities", []):
        pr = PolicyPriority(name=p["name"], weight=p.get("weight", 1))
        arg = p.get("argument") or {}
        if "serviceAntiAffinity" in arg:
            pr.service_anti_affinity_label = arg["serviceAntiAffinity"].get(
                "label", "")
        if "labelPreference" in arg:
            pr.label_preference = {
                "label": arg["labelPreference"].get("label", ""),
                "presence": arg["labelPreference"].get("presence", True),
            }
        policy.priorities.append(pr)
    return policy
