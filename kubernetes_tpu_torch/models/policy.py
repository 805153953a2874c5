"""BatchPolicy — the solver-ready form of a scheduler configuration.

Port of ``kubernetes_tpu/models/policy.py``. An algorithm provider names
(predicate, priority) sets, and a JSON Policy can instantiate the
argument-bearing plugins (ref: plugin/pkg/scheduler/factory/plugins.go:
32-195, api/types.go:23-103). The batch solver cannot call opaque plugin
functions, so the configuration is normalized into a hashable description
of exactly the reference's plugin vocabulary:

predicates — PodFitsPorts, PodFitsResources, NoDiskConflict,
    MatchNodeSelector, HostName (ref: predicates.go), CheckNodeLabelPresence
    (:194-229), CheckServiceAffinity (:238-324);
priorities — LeastRequestedPriority, ServiceSpreadingPriority, EqualPriority
    (ref: priorities.go, spreading.go:37-86), NodeLabelPriority
    (priorities.go:98-134), ServiceAntiAffinity (spreading.go:104-168).

Anything else raises :class:`UnsupportedPolicy`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from kubernetes_tpu_torch.scheduler import plugins as schedplugins

__all__ = ["BatchPolicy", "DEFAULT_BATCH_POLICY", "UnsupportedPolicy",
           "batch_policy_from"]


class UnsupportedPolicy(Exception):
    """The configured provider/policy uses plugins the batch solver does
    not model; callers must fall back to the serial scheduler."""


_KNOWN_PREDICATES = {"PodFitsPorts", "PodFitsResources", "NoDiskConflict",
                     "MatchNodeSelector", "HostName", "Schedulable"}
_KNOWN_PRIORITIES = {"LeastRequestedPriority", "ServiceSpreadingPriority",
                     "EqualPriority"}


@dataclass(frozen=True)
class BatchPolicy:
    """Normalized scheduler configuration (hashable)."""

    # Filter phase
    use_ports: bool = True
    use_resources: bool = True
    use_disk: bool = True
    use_selector: bool = True
    use_host: bool = True
    # CheckNodeLabelPresence instances: ((labels...), presence)
    label_presence: Tuple[Tuple[Tuple[str, ...], bool], ...] = ()
    # union of every CheckServiceAffinity instance's label list (per-label
    # constraints resolve independently, so the union is exact)
    affinity_labels: Tuple[str, ...] = ()
    # Score phase (summed weights of repeated entries; 0 = absent)
    w_lr: int = 1
    w_spread: int = 1
    w_equal: int = 0
    # NodeLabelPriority instances: (label, presence, weight)
    label_prefs: Tuple[Tuple[str, bool, int], ...] = ()
    # ServiceAntiAffinity instances: (label, weight)
    anti_affinity: Tuple[Tuple[str, int], ...] = ()
    # all-zero priority weights: every pod fails (generic_scheduler.go:76-80)
    all_infeasible: bool = False

    @property
    def has_affinity(self) -> bool:
        return len(self.affinity_labels) > 0


DEFAULT_BATCH_POLICY = BatchPolicy()


def _from_provider(provider: Optional[str]) -> BatchPolicy:
    keys = schedplugins.get_algorithm_provider(
        provider or schedplugins.DEFAULT_PROVIDER)
    pred_names = list(keys["predicates"])
    unknown = set(pred_names) - _KNOWN_PREDICATES
    if unknown:
        raise UnsupportedPolicy(
            f"provider predicates not modeled by the batch solver: "
            f"{sorted(unknown)}")
    prio_names = list(keys["priorities"])
    unknown = set(prio_names) - _KNOWN_PRIORITIES
    if unknown:
        raise UnsupportedPolicy(
            f"provider priorities not modeled by the batch solver: "
            f"{sorted(unknown)}")
    # registry weights: LeastRequested 1, ServiceSpreading 1,
    # EqualPriority 0 (defaults.go:66-70)
    w_lr = 1 if "LeastRequestedPriority" in prio_names else 0
    w_spread = 1 if "ServiceSpreadingPriority" in prio_names else 0
    if not prio_names:
        # empty prioritizer list -> raw EqualPriority scores
        # (generic_scheduler.go:116-117)
        w_equal, all_infeasible = 1, False
    else:
        w_equal = 0
        all_infeasible = (w_lr == 0 and w_spread == 0)
    return BatchPolicy(
        use_ports="PodFitsPorts" in pred_names,
        use_resources="PodFitsResources" in pred_names,
        use_disk="NoDiskConflict" in pred_names,
        use_selector="MatchNodeSelector" in pred_names,
        use_host="HostName" in pred_names,
        w_lr=w_lr, w_spread=w_spread, w_equal=w_equal,
        all_infeasible=all_infeasible,
    )


def batch_policy_from(provider: Optional[str] = None,
                      policy: Optional[schedplugins.Policy] = None
                      ) -> BatchPolicy:
    """Normalize an algorithm provider name or a Policy into a BatchPolicy,
    as the serial factory assembles its plugin sets (CreateFromProvider /
    CreateFromConfig, factory.go:77-104): a Policy, when given, replaces
    the provider's sets entirely."""
    if policy is None:
        return _from_provider(provider)

    # predicates: keyed by name, a later entry replaces an earlier one
    by_name = {}
    for p in policy.predicates:
        by_name[p.name] = p
    flags = dict(use_ports=False, use_resources=False, use_disk=False,
                 use_selector=False, use_host=False)
    flag_of = {"PodFitsPorts": "use_ports", "PodFitsResources":
               "use_resources", "NoDiskConflict": "use_disk",
               "MatchNodeSelector": "use_selector", "HostName": "use_host"}
    label_presence = []
    affinity_labels: list = []
    for p in by_name.values():
        if p.service_affinity_labels is not None:
            for label in p.service_affinity_labels:
                if label not in affinity_labels:
                    affinity_labels.append(label)
        elif p.label_presence is not None:
            label_presence.append((tuple(p.label_presence["labels"]),
                                   bool(p.label_presence["presence"])))
        elif p.name in flag_of:
            flags[flag_of[p.name]] = True
        elif p.name != "Schedulable":
            # (Schedulable is structural: cordon folds in unconditionally)
            raise UnsupportedPolicy(
                f"policy predicate {p.name!r} not modeled by the batch solver")

    # priorities: every entry applies, so repeated weights sum
    w = {"LeastRequestedPriority": 0, "ServiceSpreadingPriority": 0,
         "EqualPriority": 0}
    label_prefs = []
    anti_affinity = []
    any_nonzero = False
    for p in policy.priorities:
        if p.weight < 0:
            # scores could go below the solver's masked-score sentinel
            raise UnsupportedPolicy(
                f"negative priority weight on {p.name!r}")
        any_nonzero = any_nonzero or p.weight != 0
        if p.service_anti_affinity_label is not None:
            if p.weight:
                anti_affinity.append((p.service_anti_affinity_label,
                                      p.weight))
        elif p.label_preference is not None:
            if p.weight:
                label_prefs.append((p.label_preference["label"],
                                    bool(p.label_preference["presence"]),
                                    p.weight))
        elif p.name in w:
            w[p.name] += p.weight
        else:
            raise UnsupportedPolicy(
                f"policy priority {p.name!r} not modeled by the batch solver")

    if not policy.priorities:
        # empty prioritizer list -> raw EqualPriority scores, unweighted
        # (generic_scheduler.go:116-117)
        w["EqualPriority"], all_infeasible = 1, False
    else:
        all_infeasible = not any_nonzero
    return BatchPolicy(
        **flags,
        label_presence=tuple(label_presence),
        affinity_labels=tuple(affinity_labels),
        w_lr=w["LeastRequestedPriority"],
        w_spread=w["ServiceSpreadingPriority"],
        w_equal=w["EqualPriority"],
        label_prefs=tuple(label_prefs),
        anti_affinity=tuple(anti_affinity),
        all_infeasible=all_infeasible,
    )
