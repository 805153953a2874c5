"""kube-solverd wire protocol — versioned solve request/response frames.

Port of ``kubernetes_tpu/solver/protocol.py``, byte for byte on the wire:
a port client and a reference daemon (or the other way round) exchange
the same frames, derive the same fingerprints and shape buckets, and read
each other's policies. Arrays keep numpy's dtype strings on the wire
(``"uint32"`` stays ``"uint32"``); only ``batch_solver.ship_inputs``
carries uint32 words as int32 on a device.

The framing style is the one the kube-store process proved out
(storage/remote.py): length-prefixed frames over a local TCP socket. A
store frame is small JSON, but a solve request carries a wave's encoded
tensors (~27 numpy arrays, up to a few MB at full shape), so the payload
here is a JSON *header* followed by the arrays' raw bytes:

    frame   := u32 total_len | u32 header_len | header_json | array_bytes
    header  := {"v": 1, "op": ..., ...request/response fields...,
                "arrays": [[dtype_str, shape, nbytes], ...]}

Array bytes are concatenated in header order, C-contiguous, no alignment
padding (the receiver copies into fresh numpy buffers anyway). dtype
strings are numpy's (``"int32"``, ``"uint32"``, ``"bool"``, ...).

Ops:

- ``solve``: header carries ``policy`` (a BatchPolicy in wire form),
  ``gangs`` (bool), and ``fp`` — the solver-config fingerprint binding the
  request to (protocol version, policy, gangs). The arrays are the
  SolverInputs fields in ``SolverInputs._fields`` order, host-side
  (numpy), exactly what ``batch_solver.snapshot_to_host_inputs`` emits.
  Response: ``{"ok": true, "coalesced": k}`` + two arrays
  (chosen[P] i32, scores[P] i32), or ``{"busy": true}`` (queue full —
  the 429 analog; the client falls back or retries later), or
  ``{"err": ..., "msg": ...}``.
- ``ping``: health/handshake. Response carries the daemon's protocol
  version and solve statistics, so a client can refuse a version-skewed
  daemon before shipping any tensors.

**Delta frames (v2).** A full-shape wave ships several MB of planes, but
between consecutive waves of one scheduler worker only O(changed) node
rows differ — the incremental encoder keeps the node-side planes
resident, so the wire should too. A v2 ``solve`` may carry:

- ``cache``: ``{"wid": worker-id, "bucket": shape-bucket, "epoch": n}`` —
  the daemon keys a resident plane cache by (wid, bucket); ``bucket``
  digests every field's (dtype, shape), so any vocabulary growth or
  dtype flip lands in a fresh bucket and forces a full frame;
- ``planes``: one entry per SolverInputs field, in field order:
  ``"F"`` (full array follows), ``"S"`` (unchanged — daemon reuses its
  cached plane, nothing on the wire), or ``["D", k]`` (row delta: a
  ``[k] i32`` row-index array followed by a ``[k, ...]`` values array).
  Only ``DELTA_FIELDS`` (the node/group/zone resident planes) may be
  ``"S"``/``"D"``; pod-axis planes are always ``"F"``.

Epoch rule: a full frame (all-``F`` + ``cache``) installs the cache entry
at epoch ``epoch+1``; each applied delta requires the entry to be at the
request's ``epoch`` exactly and advances it by one. Any mismatch — no
entry (daemon restarted, LRU-evicted), epoch skew (a lost reply
desynced the pair), row out of range — is answered with
``{"resync": reason}`` WITHOUT solving; the client re-sends the wave as
a full frame. Solves are bit-identical by construction: the daemon
reconstructs byte-identical arrays or refuses.

A v1 client (no ``cache``/``planes``) against a v2 daemon keeps working:
the daemon treats its frames as full-plane requests and fingerprints
them with the request's own version. The fingerprint exists so the
daemon can group compatible requests for coalescing (one kernel
launch family) and reject requests from a scheduler built against an
incompatible protocol revision without decoding the tensor payload.

**Trace context (v3).** A v3 ``solve`` header may carry
``"trace": [trace_id, parent_span_id]`` — the kube-trace span context
(util/tracing.py) of the scheduler wave that shipped the frame. The
daemon attaches its queue-wait and solve spans to that trace so the
merged per-run artifact shows the wave's full causal path across the
process boundary. The field is OPTIONAL and advisory: it never affects
solving, is ignored by tracing-disabled daemons, and v1/v2 clients that
omit it are served exactly as before (untraced). It deliberately rides
the JSON header, not the fingerprint — two waves differing only in
trace context must still coalesce into one launch.
"""

from __future__ import annotations

import hashlib
import json
import socket
import struct
from dataclasses import asdict
from typing import List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.models.policy import BatchPolicy

__all__ = ["PROTOCOL_VERSION", "MIN_PROTOCOL_VERSION", "MAX_FRAME",
           "DELTA_FIELDS", "SolverProtocolError",
           "send_msg", "recv_msg", "policy_to_wire", "policy_from_wire",
           "solver_fingerprint", "shape_bucket", "parse_trace"]

PROTOCOL_VERSION = 3      # v3: optional trace context on solve frames
MIN_PROTOCOL_VERSION = 1  # v1 full-plane / v2 delta clients still served


def parse_trace(header: dict):
    """The solve header's optional trace context -> (trace_id,
    parent_span_id) tuple, or None when absent/malformed. Tolerant by
    design: a bad trace field must never fail a solve."""
    tr = header.get("trace")
    if (isinstance(tr, (list, tuple)) and len(tr) == 2
            and all(isinstance(x, str) and 0 < len(x) <= 64 for x in tr)):
        return (tr[0], tr[1])
    return None

# SolverInputs fields the daemon may cache between waves and the client
# may ship as row deltas: everything keyed on the node/group/zone axes
# (resident in models/incremental.IncrementalEncoder). Pod-axis planes
# are new every wave and always ship full.
DELTA_FIELDS = frozenset((
    "cap", "advertises", "fit_used", "fit_exceeded", "score_used",
    "node_ports", "node_sel", "node_pds", "node_extra_ok",
    "group_counts", "score_static", "node_aff_vals",
    "zone_idx", "zone_counts0",
    # kube-preempt: the evictable-band planes are node-resident like every
    # other plane above (band_prio rides along — [B] rows delta like any
    # axis-0 plane); pod_prio/pod_can_preempt are pod-axis, always full
    "evict_cap", "evict_cnt", "band_prio",
))

# A full-shape wave (10k pods x 10k nodes) encodes to a few hundred MB in
# the worst padded case; 1 GiB bounds a corrupt length word, not real use.
MAX_FRAME = 1 << 30


class SolverProtocolError(Exception):
    """Malformed frame / version skew / connection failure mid-frame."""


# -- policy (de)serialization ------------------------------------------------
# BatchPolicy is a frozen dataclass of ints/bools/nested tuples; JSON turns
# tuples into lists, so the decoder re-tuples the nested fields to restore
# hashability (the daemon groups waves by policy).

def policy_to_wire(pol: BatchPolicy) -> dict:
    return asdict(pol)


def policy_from_wire(d: dict) -> BatchPolicy:
    return BatchPolicy(
        use_ports=bool(d["use_ports"]),
        use_resources=bool(d["use_resources"]),
        use_disk=bool(d["use_disk"]),
        use_selector=bool(d["use_selector"]),
        use_host=bool(d["use_host"]),
        label_presence=tuple((tuple(labels), bool(presence))
                             for labels, presence in d["label_presence"]),
        affinity_labels=tuple(d["affinity_labels"]),
        w_lr=int(d["w_lr"]),
        w_spread=int(d["w_spread"]),
        w_equal=int(d["w_equal"]),
        label_prefs=tuple((label, bool(presence), int(w))
                          for label, presence, w in d["label_prefs"]),
        anti_affinity=tuple((label, int(w))
                            for label, w in d["anti_affinity"]),
        all_infeasible=bool(d["all_infeasible"]),
    )


def solver_fingerprint(pol: BatchPolicy, gangs: bool,
                       version: int = PROTOCOL_VERSION) -> str:
    """Canonical digest of (protocol version, policy, gangs) — the launch
    family a request belongs to. Requests sharing a fingerprint may
    be coalesced into one batched solve. ``version`` is the REQUEST's
    protocol version: a v2 daemon verifying a v1 frame must derive the
    digest the v1 client computed."""
    blob = json.dumps({"v": int(version), "policy": policy_to_wire(pol),
                       "gangs": bool(gangs)}, sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def shape_bucket(arrays) -> str:
    """Digest of every array's (dtype, shape) in order — the delta cache
    key's shape component. Any growth of a vocabulary axis, a pow-2 pod
    bucket change, or an i32/i64 dtype flip produces a new bucket, so a
    delta can never be applied across incompatible layouts."""
    blob = ";".join(f"{a.dtype.str}{tuple(a.shape)}" for a in arrays)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


# -- framing -----------------------------------------------------------------

def _recv_exact_into(sock: socket.socket, view: memoryview) -> bool:
    """Fill ``view`` from the socket; False on EOF before it filled."""
    while view:
        n = sock.recv_into(view)
        if n == 0:
            return False
        view = view[n:]
    return True


def send_msg(sock: socket.socket, header: dict,
             arrays: Tuple[np.ndarray, ...] = ()) -> None:
    """Serialize and send one frame. ``header["arrays"]`` is filled in from
    ``arrays`` (dtype/shape/nbytes per array, in order). Array payloads go
    out as zero-copy memoryviews — a full-shape wave is hundreds of MB,
    so tobytes()+join would add two transient full-payload copies to the
    hot path."""
    meta = []
    views: List[memoryview] = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        meta.append([str(a.dtype), list(a.shape), a.nbytes])
        if a.nbytes:  # zero-size planes carry no payload (and can't cast)
            views.append(memoryview(a).cast("B"))
    header = dict(header, arrays=meta)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body_len = 4 + len(hjson) + sum(v.nbytes for v in views)
    if body_len > MAX_FRAME:
        raise SolverProtocolError(f"frame too large: {body_len} bytes")
    sock.sendall(struct.pack(">II", body_len, len(hjson)) + hjson)
    for v in views:
        sock.sendall(v)


def recv_msg(sock: socket.socket
             ) -> Optional[Tuple[dict, List[np.ndarray]]]:
    """Receive one frame -> (header, arrays), or None on clean EOF.
    Arrays are writable zero-copy views over ONE receive buffer (a
    bytearray is a writable buffer, so np.frombuffer over it is too);
    the buffer lives as long as any returned array does."""
    head = bytearray(4)
    if not _recv_exact_into(sock, memoryview(head)):
        return None
    (total,) = struct.unpack(">I", head)
    if total > MAX_FRAME or total < 4:
        raise SolverProtocolError(f"bad frame length {total}")
    body = bytearray(total)
    if not _recv_exact_into(sock, memoryview(body)):
        raise SolverProtocolError("connection closed mid-frame")
    (hlen,) = struct.unpack(">I", body[:4])
    if hlen > total - 4:
        raise SolverProtocolError(f"bad header length {hlen}")
    try:
        header = json.loads(bytes(body[4:4 + hlen]))
    except ValueError as e:
        raise SolverProtocolError(f"bad header json: {e}")
    arrays: List[np.ndarray] = []
    off = 4 + hlen
    for dtype_str, shape, nbytes in header.get("arrays", ()):
        if off + nbytes > total:
            raise SolverProtocolError("truncated array payload")
        dt = np.dtype(dtype_str)
        arr = np.frombuffer(body, dtype=dt, count=nbytes // dt.itemsize,
                            offset=off).reshape(shape)
        arrays.append(arr)
        off += nbytes
    return header, arrays
