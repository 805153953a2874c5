"""Carry a wave encoded by the JAX package into the port.

``inputs_from_reference`` takes the field dict of the reference's
``snapshot_to_host_inputs(snap)._asdict()`` as numpy arrays and returns
the port's SolverInputs on a torch device, so both packages can solve the
identical wave. Two torch dtype gaps shape the carry: uint32 port and PD
words travel as int32 bit patterns, and the FNV-1a tie hash stays as its
(hi, lo) int64 halves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from kubernetes_tpu_torch.models.batch_solver import SolverInputs, ship_inputs

__all__ = ["inputs_from_reference"]


def _refuse_extensions(arrays: Dict[str, np.ndarray]) -> None:
    """The reference's SolverInputs also carries the planes of features
    this slice does not solve; a wave that uses one is refused."""
    # (feature, array, axis whose extent is nonzero when the feature is on)
    for feature, name, axis in (("preemption", "band_prio", 0),
                                ("ServiceAntiAffinity", "zone_idx", 0),
                                ("ServiceAffinity", "node_aff_vals", 1)):
        a = arrays.get(name)
        if a is not None and a.shape[axis]:
            raise NotImplementedError(
                f"{feature} waves are not ported yet (ROADMAP Queue 1)")
    static = arrays.get("score_static")
    if static is not None and np.any(static):
        raise NotImplementedError(
            "NodeLabelPriority waves are not ported yet (ROADMAP Queue 1)")
    start = arrays.get("gang_start")
    if start is not None and not np.all(start):
        raise NotImplementedError(
            "gang waves are not ported yet (ROADMAP Queue 1)")
    if np.asarray(arrays["cap"]).dtype != np.int32:
        raise NotImplementedError(
            "int64 resource planes are not ported yet (ROADMAP Queue 1)")


def inputs_from_reference(arrays: Dict[str, np.ndarray],
                          device) -> SolverInputs:
    """Reference host-input fields (numpy) -> the port's SolverInputs on
    ``device``."""
    _refuse_extensions(arrays)
    host = SolverInputs(*(np.asarray(arrays[f]) for f in SolverInputs._fields))
    return ship_inputs(host, device)
