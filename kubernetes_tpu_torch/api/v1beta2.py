"""v1beta2 — the second legacy wire version: v1beta1's envelope without
the deprecated aliases.

Port of ``kubernetes_tpu/api/v1beta2.py``.

ref: pkg/api/v1beta2/{types,conversion,defaults}.go. In the reference,
v1beta2 is a near-copy of v1beta1 that shipped side by side with it: the
same flat metadata/``id``, desiredState/currentState envelopes,
manifest-nested pod specs, one-of restart policies, ``Minion`` wire kind,
``podID`` bindings and ``ip:port`` endpoints — but with the era's
deprecated duplicate fields *removed*:

- no ``EnvVar.key`` (v1beta1 writes it as a duplicate of ``name``;
  v1beta2/types.go has no Key field — the v1beta1-only conversion is
  pkg/api/v1beta1/conversion.go:114-129);
- no ``VolumeMount.path``/``mountType`` (v1beta1/conversion.go:131-149);
- no ``MinionList.minions`` duplicate of ``items``
  (v1beta1/conversion.go:151-196);
- manifests stamp ``version: v1beta2``.

Defaulting is code-identical to v1beta1 (diff of the two defaults.go
files shows only a comment divergence over defaultHostNetworkPorts), so
the DEFAULTERS/FIELD_LABELS/KIND_ALIASES registries are shared. What
this module proves is the *version lifecycle*: three wire formats
registered simultaneously, each decodable, with cross-version
conversion through the internal form (the kube-version-change path).
"""

from __future__ import annotations

from typing import Dict, Tuple

from kubernetes_tpu_torch.api import v1beta1 as _beta1
from kubernetes_tpu_torch.api.v1beta1 import (DEFAULTERS, FIELD_LABELS,
                                        KIND_ALIASES, WireFn)

__all__ = ["KIND_TRANSFORMS", "KIND_ALIASES", "DEFAULTERS",
           "FIELD_LABELS", "encode_for", "decode_for"]

# same envelope, no legacy aliases, own manifest stamp
KIND_TRANSFORMS: Dict[str, Tuple[WireFn, WireFn]] = \
    _beta1.make_kind_transforms("v1beta2", legacy_aliases=False)


def encode_for(kind: str) -> WireFn:
    return _beta1.encode_for(kind, KIND_TRANSFORMS)


def decode_for(kind: str) -> WireFn:
    return _beta1.decode_for(kind, KIND_TRANSFORMS)
