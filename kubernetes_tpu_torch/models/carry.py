"""Carry a wave encoded by the JAX package into the port.

``inputs_from_reference`` takes the field dict of the reference's
``snapshot_to_host_inputs(snap)._asdict()`` as numpy arrays and returns
the port's SolverInputs on a torch device, so both packages can solve the
identical wave: int32 or int64 resource planes, and the preemption band
and evictable planes as they are. Two torch dtype gaps shape the carry:
uint32 port and PD words travel as int32 bit patterns, and the FNV-1a tie
hash stays as its (hi, lo) int64 halves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from kubernetes_tpu_torch.models.batch_solver import SolverInputs, ship_inputs

__all__ = ["inputs_from_reference"]


def inputs_from_reference(arrays: Dict[str, np.ndarray],
                          device) -> SolverInputs:
    """Reference host-input fields (numpy) -> the port's SolverInputs on
    ``device``."""
    host = SolverInputs(*(np.asarray(arrays[f]) for f in SolverInputs._fields))
    return ship_inputs(host, device)
