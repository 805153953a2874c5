"""Carry a wave encoded by the JAX package into the port.

``inputs_from_reference`` takes the field dict of the reference's
``snapshot_to_host_inputs(snap)._asdict()`` as numpy arrays and returns
the port's SolverInputs on a torch device, so both packages can solve the
identical wave. Two torch dtype gaps shape the carry: uint32 port and PD
words travel as int32 bit patterns, and the FNV-1a tie hash stays as its
(hi, lo) int64 halves. The reference's preemption planes are not carried:
a wave that uses them is refused, as is one with int64 resource planes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from kubernetes_tpu_torch.models.batch_solver import SolverInputs, ship_inputs

__all__ = ["inputs_from_reference"]


def _refuse_unported(arrays: Dict[str, np.ndarray]) -> None:
    """Refuse, by ROADMAP item, a wave the port does not solve yet."""
    band_prio = arrays.get("band_prio")
    if band_prio is not None and band_prio.shape[0]:
        raise NotImplementedError(
            "preemption waves are not ported yet (ROADMAP Queue 1: "
            "preemption)")
    if np.asarray(arrays["cap"]).dtype != np.int32:
        raise NotImplementedError(
            "int64 resource planes are not ported yet (ROADMAP Queue 1: "
            "int64 resource planes)")


def inputs_from_reference(arrays: Dict[str, np.ndarray],
                          device) -> SolverInputs:
    """Reference host-input fields (numpy) -> the port's SolverInputs on
    ``device``."""
    _refuse_unported(arrays)
    host = SolverInputs(*(np.asarray(arrays[f]) for f in SolverInputs._fields))
    return ship_inputs(host, device)
