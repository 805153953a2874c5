"""BatchPolicy — the solver-ready form of a scheduler configuration.

Port of ``kubernetes_tpu/models/policy.py``. The dataclass keeps every
field of the reference, so a configuration the port does not solve yet is
recognised and refused rather than misread; ``batch_policy_from`` ports
the provider branch only (a JSON Policy file is ROADMAP work).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from kubernetes_tpu_torch.scheduler import plugins as schedplugins

__all__ = ["BatchPolicy", "DEFAULT_BATCH_POLICY", "UnsupportedPolicy",
           "batch_policy_from"]


class UnsupportedPolicy(Exception):
    """The configured provider uses plugins the batch solver does not
    model; callers must fall back to the serial scheduler."""


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
    # CheckServiceAffinity labels
    affinity_labels: Tuple[str, ...] = ()
    # Score phase (summed weights; 0 = absent)
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
    def extensions(self) -> Tuple[str, ...]:
        """Names of the policy plugins set here that this slice of the
        port does not solve (ROADMAP: policy breadth)."""
        out = []
        if self.label_presence:
            out.append("CheckNodeLabelPresence")
        if self.affinity_labels:
            out.append("ServiceAffinity")
        if self.label_prefs:
            out.append("NodeLabelPriority")
        if self.anti_affinity:
            out.append("ServiceAntiAffinity")
        return tuple(out)


DEFAULT_BATCH_POLICY = BatchPolicy()


def batch_policy_from(provider: Optional[str] = None,
                      policy=None) -> BatchPolicy:
    """Normalize an algorithm provider name into a BatchPolicy, as the
    serial factory assembles its plugin sets (CreateFromProvider,
    factory.go:77-87)."""
    if policy is not None:
        raise NotImplementedError(
            "a JSON scheduler Policy is not ported yet (ROADMAP Queue 1: "
            "policy breadth); pass a provider name")
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
