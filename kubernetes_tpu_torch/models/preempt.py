"""Priority bands — the encoder's preemption emit gate.

Port of the part of ``kubernetes_tpu/models/preempt.py`` the encoders
call: ``BAND_EMPTY``, ``derive_evict_planes`` and the ``ResidentPod`` row
of the incremental encoder's per-node registry. A wave whose pending pods sit
strictly above some resident band carries these planes; solving such a
wave (the preemption sub-program) is ROADMAP work and the port refuses it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["BAND_EMPTY", "ResidentPod", "derive_evict_planes"]

# Empty/padded band slots: above every legal pod priority, so a padded
# slot is never "strictly lower" than any pod.
BAND_EMPTY = np.int32(2**31 - 1)


class ResidentPod(NamedTuple):
    """A node-resident pod as the victim replay sees it, from the
    IncrementalEncoder's registry."""

    uid: str
    name: str
    namespace: str
    host_idx: int
    priority: int


def derive_evict_planes(e_host: np.ndarray, e_prio: np.ndarray,
                        e_req: np.ndarray, band_prio: np.ndarray,
                        n_nodes: int):
    """``evict_cap[n, b, :]`` = summed request vectors of pods resident on
    node ``n`` whose priority equals ``band_prio[b]``; ``evict_cnt`` the
    matching pod counts. ``e_host >= n_nodes`` marks off-list pods."""
    B = len(band_prio)
    R = e_req.shape[1] if e_req.ndim == 2 else 0
    cap = np.zeros((n_nodes, B, R), np.int64)
    cnt = np.zeros((n_nodes, B), np.int32)
    slot_of = {int(v): b for b, v in enumerate(band_prio)
               if int(v) != int(BAND_EMPTY)}
    for k in range(len(e_host)):
        i = int(e_host[k])
        if i >= n_nodes:
            continue
        b = slot_of.get(int(e_prio[k]))
        if b is None:
            continue
        cap[i, b] += e_req[k]
        cnt[i, b] += 1
    return cap, cnt
