"""Scheduler plugin registry + algorithm providers + policy config.

Port of ``kubernetes_tpu/scheduler/plugins.py``: a rebuild of
``plugin/pkg/scheduler/factory/plugins.go:32-195`` (name->factory
maps with RegisterFitPredicate / RegisterPriority / RegisterAlgorithmProvider),
``plugin/pkg/scheduler/algorithmprovider/defaults/defaults.go:26-72`` (the
default provider), and ``plugin/pkg/scheduler/api/types.go:23-103`` (the
versioned JSON Policy file with predicate/priority arguments).

This registry is the plugin boundary both backends share: the serial
GenericScheduler and the batch solver are built from the same
(predicate-set, priority-set) selection.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.scheduler import predicates as preds
from kubernetes_tpu_torch.scheduler import priorities as prios
from kubernetes_tpu_torch.scheduler.priorities import PriorityConfig

__all__ = ["PluginFactoryArgs", "register_fit_predicate", "register_priority",
           "register_algorithm_provider", "get_predicates", "get_priorities",
           "get_algorithm_provider", "Policy", "PolicyPredicate", "PolicyPriority",
           "load_policy", "DEFAULT_PROVIDER"]


@dataclass
class PluginFactoryArgs:
    """ref: plugins.go:32 PluginFactoryArgs."""

    pod_lister: object = None
    service_lister: object = None
    node_lister: object = None
    node_info: object = None


_fit_predicate_factories: Dict[str, Callable[[PluginFactoryArgs], preds.FitPredicate]] = {}
_priority_factories: Dict[str, Callable[[PluginFactoryArgs], PriorityConfig]] = {}
_algorithm_providers: Dict[str, dict] = {}

DEFAULT_PROVIDER = "DefaultProvider"


def register_fit_predicate(name: str, factory) -> str:
    """ref: plugins.go:65-79 RegisterFitPredicate."""
    _fit_predicate_factories[name] = factory
    return name


def register_priority(name: str, factory) -> str:
    """ref: plugins.go:129-145 RegisterPriorityConfigFactory."""
    _priority_factories[name] = factory
    return name


def register_algorithm_provider(name: str, predicate_keys: List[str],
                                priority_keys: List[str]) -> str:
    """ref: plugins.go:195 RegisterAlgorithmProvider."""
    _algorithm_providers[name] = {
        "predicates": list(predicate_keys),
        "priorities": list(priority_keys),
    }
    return name


def get_algorithm_provider(name: str) -> dict:
    return _algorithm_providers[name]


def get_predicates(names: List[str], args: PluginFactoryArgs
                   ) -> Dict[str, preds.FitPredicate]:
    out = {}
    for n in names:
        if n not in _fit_predicate_factories:
            raise KeyError(f"invalid predicate name {n!r}")
        out[n] = _fit_predicate_factories[n](args)
    return out


def get_priorities(names: List[str], args: PluginFactoryArgs) -> List[PriorityConfig]:
    out = []
    for n in names:
        if n not in _priority_factories:
            raise KeyError(f"invalid priority name {n!r}")
        out.append(_priority_factories[n](args))
    return out


# ---------------------------------------------------------------------------
# Built-in registrations (ref: defaults.go:26-72 defaultPredicates/Priorities)
# ---------------------------------------------------------------------------

register_fit_predicate("PodFitsPorts", lambda args: preds.pod_fits_ports)
register_fit_predicate(
    "PodFitsResources",
    lambda args: preds.ResourceFit(args.node_info).pod_fits_resources)
register_fit_predicate("NoDiskConflict", lambda args: preds.no_disk_conflict)
register_fit_predicate(
    "MatchNodeSelector",
    lambda args: preds.NodeSelector(args.node_info).pod_selector_matches)
register_fit_predicate("HostName", lambda args: preds.pod_fits_host)
register_fit_predicate(
    "Schedulable",
    lambda args: preds.Schedulable(args.node_info).pod_is_schedulable)

register_priority(
    "LeastRequestedPriority",
    lambda args: PriorityConfig(function=prios.least_requested_priority, weight=1))
register_priority(
    "ServiceSpreadingPriority",
    lambda args: PriorityConfig(
        function=prios.ServiceSpread(args.service_lister).calculate_spread_priority,
        weight=1))
register_priority(
    "EqualPriority",
    lambda args: PriorityConfig(function=prios.equal_priority, weight=0))

register_algorithm_provider(
    DEFAULT_PROVIDER,
    predicate_keys=["PodFitsPorts", "PodFitsResources", "NoDiskConflict",
                    "MatchNodeSelector", "HostName", "Schedulable"],
    priority_keys=["LeastRequestedPriority", "ServiceSpreadingPriority",
                   "EqualPriority"],
)


# ---------------------------------------------------------------------------
# Policy config (ref: plugin/pkg/scheduler/api/types.go:23-103 + v1/)
# ---------------------------------------------------------------------------


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
            pp.service_affinity_labels = arg["serviceAffinity"].get("labels", [])
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
            pr.service_anti_affinity_label = arg["serviceAntiAffinity"].get("label", "")
        if "labelPreference" in arg:
            pr.label_preference = {
                "label": arg["labelPreference"].get("label", ""),
                "presence": arg["labelPreference"].get("presence", True),
            }
        policy.priorities.append(pr)
    return policy


def predicates_from_policy(policy: Policy, args: PluginFactoryArgs
                           ) -> Dict[str, preds.FitPredicate]:
    """Build the predicate map from a Policy, instantiating the
    argument-bearing custom predicates (ref: plugins.go:81-127
    RegisterCustomFitPredicate)."""
    out: Dict[str, preds.FitPredicate] = {}
    for p in policy.predicates:
        if p.service_affinity_labels is not None:
            out[p.name] = preds.ServiceAffinity(
                args.pod_lister, args.service_lister, args.node_info,
                p.service_affinity_labels).check_service_affinity
        elif p.label_presence is not None:
            out[p.name] = preds.NodeLabelChecker(
                args.node_info, p.label_presence["labels"],
                p.label_presence["presence"]).check_node_label_presence
        else:
            out.update(get_predicates([p.name], args))
    # cordon is structural, not policy vocabulary: every configuration
    # refuses unschedulable nodes, exactly as the dense planes fold
    # spec.unschedulable into node_extra_ok unconditionally
    out.setdefault("Schedulable",
                   preds.Schedulable(args.node_info).pod_is_schedulable)
    return out


def priorities_from_policy(policy: Policy, args: PluginFactoryArgs) -> List[PriorityConfig]:
    out: List[PriorityConfig] = []
    for p in policy.priorities:
        if p.service_anti_affinity_label is not None:
            out.append(PriorityConfig(
                function=prios.ServiceAntiAffinity(
                    args.service_lister,
                    p.service_anti_affinity_label).calculate_anti_affinity_priority,
                weight=p.weight))
        elif p.label_preference is not None:
            out.append(PriorityConfig(
                function=prios.NodeLabelPrioritizer(
                    p.label_preference["label"],
                    p.label_preference["presence"]).calculate_node_label_priority,
                weight=p.weight))
        else:
            cfg = get_priorities([p.name], args)[0]
            cfg.weight = p.weight
            out.append(cfg)
    return out
