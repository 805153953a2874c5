"""kube-solverd — the shared solver daemon with wave coalescing.

Port of ``kubernetes_tpu/solver/service.py``. N scheduler worker processes
share one card through this process: each ships its wave's host inputs
over a local socket (``client.RemoteSolver``) and gets the decisions back.

**Wave coalescing.** Requests arriving within a short gather window are
solved by ONE device call and fanned back out per requester:

- requests sharing a solver configuration (policy, gangs, resource type,
  the affinity and anti-affinity label counts) form a group, and each
  request's SolverInputs is padded to the group's per-axis maximum with
  the reference's decision-invariant fills: pad nodes carry
  ``node_extra_ok=False`` (never feasible, advertise nothing, zero
  capacity), pad pods come last and pin to host index -2 with zero
  requests (never placed, commit nothing), pad vocabulary and zone
  columns are zero (no conflicts, no violations, zero scores), pad bands
  are BAND_EMPTY (never below a priority), and the group-counts off-list
  column moves with the node axis;
- the padded waves inside the kernel's domain run as ONE launch of the
  commit_solve kernel, one block (one SM of the card's 132) per wave
  (``ops/commit_solver.solve_commit_batch``): the reference's
  ``jit(vmap(solve_jit))`` batch axis becomes the grid. A wave outside
  the domain runs ``solve_scan`` on the same device, one by one, as
  ``batch_solver.solve_device`` sends it. Every decision is exact
  integer (or IEEE float32) arithmetic, so a coalesced wave decides
  exactly as it would alone.

Unlike the reference, which pads every axis to a power of two and the
batch axis by replicating its first wave because XLA compiles one program
per shape, the kernel has no per-shape compile: the target is the group's
per-axis maximum (a lone wave is not padded at all) and the batch axis is
the waves themselves. Pow-2 node padding would cost the kernel twice the
pod-node pairs and push a north_star wave's node state out of shared
memory.

**One CUDA thread.** Only the solver thread touches the device: it ships,
prepares (the selector product switches TF32 off process-wide), launches
and reads back, and it runs the prewarm thread's launches between groups
(each at its exemplar's own shape, once per kernel instance).
Connection threads decode frames and rebuild delta planes in numpy.

**Backpressure.** The request queue is bounded: when ``max_queue`` waves
wait, a new request gets an immediate BUSY reply (the apiserver's 429)
and the client solves that wave in its own process, on its own card.

**Delta wire (protocol v2).** The daemon keeps a resident plane cache
keyed by (worker id, shape bucket): after a full frame, a client ships
only the changed rows of the node, group and zone planes
(``protocol.DELTA_FIELDS``) plus the wave's pod planes. Reconstruction is
copy-on-write in numpy (an applied delta makes NEW arrays, never touching
planes a queued wave still references), and the cache entry is installed
only when the wave is enqueued, so a BUSY bounce leaves both sides
consistent. A missing entry, an epoch skew or a row out of range is
answered ``{"resync": reason}`` before any solve; the client re-sends the
wave as a full frame.

**The device mesh** (``mesh``, solver/mesh_exec.py): with ``mesh="on"``
(or ``auto`` on a host with more than one CUDA device) a single-wave group
at or above the executor's node floor that the kernel cannot take (on a
card: more than 32,640 nodes, 31 services or 32 bands) solves through the
``MeshExecutor``, from device-resident planes sharded over the node axis,
with the delta wire's changed rows scattered onto them. ``on`` raises
``parallel.mesh.MeshUnavailable`` on a host with one device.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.models.batch_solver import (
    SolverInputs,
    peer_bound_of,
    resolve_device,
    ship_inputs,
    snapshot_to_host_inputs,
    solve_scan,
)
from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.models.snapshot import _pow2_pad, encode_snapshot
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.solver import protocol
from kubernetes_tpu_torch.solver.prewarm import PrewarmController, pow2_ladder
from kubernetes_tpu_torch.util import metrics, tracing

__all__ = ["SolverService"]

_log = logging.getLogger("kubernetes_tpu_torch.solver.service")

# SolverInputs field -> (axis names, pad fill). Axis names resolve against
# the per-group target dims; fills are the decision-invariant values the
# module docstring argues for. N1 (group_counts' node axis) is special:
# its last column is the off-list slot and must stay last after padding.
_PAD_SPEC = {
    "cap":             (("N", "R"), 0),
    "advertises":      (("N", "R"), False),
    "fit_used":        (("N", "R"), 0),
    "fit_exceeded":    (("N",), False),
    "score_used":      (("N", "R"), 0),
    "node_ports":      (("N", "Wp"), 0),
    "node_sel":        (("N", "Ks"), False),
    "node_pds":        (("N", "Wd"), 0),
    "node_extra_ok":   (("N",), False),
    "req":             (("P", "R"), 0),
    "pod_ports":       (("P", "Wp"), 0),
    "pod_sel":         (("P", "Ks"), False),
    "pod_pds":         (("P", "Wd"), 0),
    "pod_host_idx":    (("P",), -2),
    "tie_hi":          (("P",), 0),
    "tie_lo":          (("P",), 0),
    "pod_gid":         (("P",), -1),
    "pod_group_member": (("P", "G"), False),
    "group_counts":    (("G", "N1"), 0),
    "gang_start":      (("P",), True),
    "score_static":    (("N",), 0),
    "node_aff_vals":   (("N", "L"), -1),
    "pod_aff_static":  (("P", "L"), -2),
    "anchor_vals0":    (("G", "L"), 0),
    "has_anchor0":     (("G",), False),
    "zone_idx":        (("A", "N"), -1),   # pad nodes are unlabeled
    "zone_counts0":    (("A", "G", "V"), 0),  # phantom zones hold no peers
    # preemption: pad pods carry priority 0 and can never preempt; pad
    # bands are BAND_EMPTY (never strictly below any priority); pad nodes
    # hold no evictable pods
    "pod_prio":        (("P",), 0),
    "pod_can_preempt": (("P",), False),
    "band_prio":       (("B",), 2**31 - 1),
    "evict_cap":       (("N", "B", "R"), 0),
    "evict_cnt":       (("N", "B"), 0),
}


def _dims_of(inp) -> Dict[str, int]:
    return {
        "N": inp.cap.shape[0], "R": inp.cap.shape[1],
        "Wp": inp.node_ports.shape[1], "Ks": inp.node_sel.shape[1],
        "Wd": inp.node_pds.shape[1], "P": inp.req.shape[0],
        "G": inp.group_counts.shape[0], "L": inp.node_aff_vals.shape[1],
        "A": inp.zone_idx.shape[0], "V": inp.zone_counts0.shape[2],
        "B": inp.band_prio.shape[0],
    }


def _target_dims(all_dims: List[Dict[str, int]]) -> Dict[str, int]:
    """Group target: the per-axis maximum. A lone wave keeps its own shape,
    and B stays 0 when no wave has bands."""
    t = {k: max(d[k] for d in all_dims) for k in all_dims[0]}
    t["N1"] = t["N"] + 1
    return t


def _bucket_dims(target: Dict[str, int]) -> Dict[str, int]:
    """The reference's pow-2 bucket of a target (``_target_dims`` of
    kubernetes_tpu/solver/service.py): the prewarm controller's key only,
    never a padding target here."""
    b: Dict[str, int] = {}
    for k, m in target.items():
        if k in ("L", "A", "N1"):
            b[k] = m
        elif k == "B":
            b[k] = 0 if m == 0 else _pow2_pad(m, minimum=2)
        elif k == "G":
            b[k] = _pow2_pad(m, minimum=8)
        else:
            b[k] = _pow2_pad(m, minimum=1)
    b["N1"] = b["N"] + 1
    return b


def _pad_inputs(inp, target: Dict[str, int]):
    """Pad one request's SolverInputs to the group target shape with the
    decision-invariant fills; returns the same NamedTuple type."""
    out = []
    for name, arr in zip(inp._fields, inp):
        axes, fill = _PAD_SPEC[name]
        want = tuple(target[a] for a in axes)
        if arr.shape == want:
            out.append(arr)
            continue
        if name == "group_counts":
            # off-list slot is the LAST column at every size: move it
            g, n1 = arr.shape
            grown = np.zeros(want, arr.dtype)
            grown[:g, :n1 - 1] = arr[:, :n1 - 1]
            grown[:g, want[1] - 1] = arr[:, n1 - 1]
            out.append(grown)
            continue
        grown = np.full(want, fill, arr.dtype)
        grown[tuple(slice(0, s) for s in arr.shape)] = arr
        out.append(grown)
    return type(inp)(*out)


class _SolverdMetrics:
    _singleton = None

    def __init__(self):
        reg = metrics.default_registry()
        self.queue_depth = reg.gauge(
            "solverd_queue_depth", "Waves waiting for the gather window")
        self.requests = reg.counter(
            "solverd_requests_total", "Solve requests by outcome",
            ("outcome",))
        self.waves = reg.counter(
            "solverd_coalesced_waves_total",
            "Waves folded into batched device solves")
        self.solves = reg.counter(
            "solverd_device_solves_total",
            "Batched device solve calls (coalesce factor = waves/solves)")
        self.batch = reg.histogram(
            "solverd_batch_waves", "Waves per batched solve",
            buckets=(1, 2, 4, 8, 16, 32))
        self.occupancy = reg.histogram(
            "solverd_gather_occupancy",
            "Gather-window fill fraction (waves gathered / max_batch)",
            buckets=(0.0625, 0.125, 0.25, 0.5, 0.75, 1.0))
        self.solve_s = reg.histogram(
            "solverd_solve_seconds", "Batched solve wall time",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.02, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5))


def _solverd_metrics() -> _SolverdMetrics:
    if _SolverdMetrics._singleton is None:
        _SolverdMetrics._singleton = _SolverdMetrics()
    return _SolverdMetrics._singleton


class _Req:
    __slots__ = ("inp", "pol", "gangs", "p", "conn", "send_lock",
                 "cache_key", "delta", "trace", "t_enq")

    def __init__(self, inp, pol, gangs, p, conn, send_lock,
                 cache_key=None, delta=None, trace=None):
        self.inp = inp          # host-side SolverInputs (numpy)
        self.pol = pol
        self.gangs = gangs
        self.p = p              # requester's pod-axis length (reply slice)
        self.conn = conn
        self.send_lock = send_lock
        # delta-wire residency handles for the mesh executor: the cache
        # entry this wave belongs to and, per changed plane, the
        # (base, rows, vals) triple the executor can scatter onto its
        # resident device plane instead of a full re-transfer
        self.cache_key = cache_key
        self.delta = delta
        # v3 trace context of the requesting wave (protocol.parse_trace)
        # + enqueue instant: the daemon's queue-wait and solve spans
        # attach to the wave's trace
        self.trace = trace
        self.t_enq = time.monotonic_ns()


class _PrewarmJob:
    """A prewarm launch handed from the prewarm thread to the solver
    thread, the only thread that touches the device."""

    __slots__ = ("stacked", "pol", "gangs", "done", "error")

    def __init__(self, stacked, pol, gangs):
        self.stacked = stacked
        self.pol = pol
        self.gangs = gangs
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


class SolverService:
    """The kube-solverd daemon loop. One thread per connection reads and
    enqueues requests (replying BUSY itself when the queue is full); ONE
    solver thread gathers, coalesces, solves, and writes replies. Solves
    run on ``device``: ``cuda`` unless the caller names another; ``cpu``
    runs the kernel's plain version."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 gather_window_s: float = 0.003, max_batch: int = 16,
                 max_queue: int = 64, cache_entries: int = 64,
                 mesh: str = "auto", pods_axis: int = 1,
                 mesh_min_nodes=None, mesh_dispatch: str = "auto",
                 mesh_probe: str = "first", prewarm: bool = False,
                 prewarm_nodes: int = 0, prewarm_pods: int = 1024,
                 prewarm_batch: int = 1, device=None):
        # device-mesh dispatch (solver/mesh_exec.py): on when more than one
        # device is attached (auto) or demanded (on); single-wave groups
        # the executor takes then solve from device-resident shards
        from kubernetes_tpu_torch.parallel.mesh import maybe_mesh
        self._mesh_exec = None
        if maybe_mesh(mesh, pods_axis) is not None:
            from kubernetes_tpu_torch.solver.mesh_exec import MeshExecutor
            self._mesh_exec = MeshExecutor(
                pods_axis=pods_axis, min_nodes=mesh_min_nodes,
                dispatch=mesh_dispatch, probe=mesh_probe,
                cache_entries=cache_entries)
            _log.info("mesh dispatch enabled: %d devices, pods_axis=%d, "
                      "node_shards=%d, min_nodes=%d, dispatch=%s",
                      self._mesh_exec.mesh.size, pods_axis,
                      self._mesh_exec.node_shards,
                      self._mesh_exec.min_nodes, mesh_dispatch)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.gather_window_s = gather_window_s
        self.max_batch = max_batch
        self.max_queue = max_queue
        # delta-wire resident plane cache: (wid, bucket) -> {"epoch": n,
        # "planes": {field: np.ndarray}} — arrays are immutable by
        # convention (copy-on-write on delta apply), LRU-bounded
        self.cache_entries = cache_entries
        self._plane_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self._stopped = threading.Event()
        self._cond = threading.Condition()
        # ktpu-vet: ok thread-discipline — bounded by the BUSY backpressure
        # check (len >= max_queue under _cond) before every append
        self._pending: deque = deque()
        # ktpu-vet: ok thread-discipline — one entry per prewarm target
        # at a time: the prewarm thread waits for its job before the next
        self._prewarm_jobs: deque = deque()
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._m = _solverd_metrics()
        self._dm = metrics.solverd_delta_metrics()
        self._sx = metrics.slipstream_metrics()
        # device-call / wave counters, exposed for tests and /metrics alike:
        # solve_calls counts device calls of live groups, batched_solves
        # every call that launched the kernel (prewarm launches included),
        # scan_waves the waves outside the kernel's domain (solve_scan)
        self.solve_calls = 0
        self.waves_served = 0
        self.batched_solves = 0
        self.scan_waves = 0
        self.prewarm_launches = 0
        self.prewarm_skipped = 0    # jobs whose instance had launched
        self.prewarm_s = 0.0        # solver-thread seconds of prewarm jobs,
                                    # skipped ones included
        self.delta_waves = 0
        self.resync_replies = 0
        # prewarm (solver/prewarm.py): the fill trigger watches every
        # group's true occupancy against the pow-2 bucket it falls in
        # (BATCH = the waves in one launch) and queues the next bucket;
        # --prewarm boot mode seeds the buckets implied by the declared
        # cluster size. A bucket is a key only: its job launches the
        # latest exemplar at the exemplar's own shape, and only for an
        # instance not launched yet (_prewarm_compile)
        self._prewarm = PrewarmController(self._prewarm_compile,
                                          name="solverd-prewarm")
        self._prewarm_exemplar = None    # (SolverInputs, pol, gangs)
        self._boot_hints = (int(prewarm_nodes), int(prewarm_pods),
                            int(prewarm_batch)) if prewarm else None
        # worker-reported encoder resync accounting (the "enc" header
        # field each solve frame piggybacks): latest [replay, full]
        # totals per worker, exposed as fleet-sum gauges on /metrics
        self._enc_reported: Dict[str, Tuple[int, int]] = {}
        self._enc_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    @property
    def address(self) -> str:
        host, port = self._sock.getsockname()[:2]
        return f"{host}:{port}"

    def _start_prewarm(self) -> None:
        self._prewarm.start()
        if self._boot_hints is not None:
            threading.Thread(target=self._prewarm_boot, daemon=True,
                             name="solverd-prewarm-boot").start()

    def start(self) -> "SolverService":
        self._start_prewarm()
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="solverd-accept")
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._solve_loop, daemon=True,
                             name="solverd-solve")
        t.start()
        self._threads.append(t)
        return self

    def serve_forever(self) -> None:
        self._start_prewarm()
        t = threading.Thread(target=self._solve_loop, daemon=True,
                             name="solverd-solve")
        t.start()
        self._threads.append(t)
        self._accept_loop()

    def stop(self) -> None:
        self._stopped.set()
        self._prewarm.stop()
        with self._cond:
            self._cond.notify_all()
        try:
            # shutdown BEFORE close: close() alone does not wake a thread
            # blocked in accept(), and while that syscall blocks the
            # kernel keeps the socket in LISTEN — a restarted daemon then
            # can't rebind the port
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # close accepted connections too: their threads are blocked in
        # recv, and a lingering child socket keeps the port unbindable
        # for a restarted daemon
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def join(self, timeout: float = 10.0) -> bool:
        """Wait for the accept and solver threads after ``stop``; True
        when both ended."""
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)

    # -- connection side ---------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # accepted sockets do NOT inherit the listener's SO_REUSEADDR;
            # without it their FIN_WAIT remnants block a restarted daemon
            # from rebinding the port
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            # Bounded SEND only (not settimeout, which would also kill
            # idle keep-alive recv): replies are written by the ONE solver
            # thread, so a stalled client with a full receive buffer would
            # otherwise wedge every queued wave daemon-wide. On timeout
            # sendall raises (caught as OSError) and the reply is dropped.
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", 30, 0))
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="solverd-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # the reply to an accepted solve is written by the solver thread;
        # BUSY/error/ping replies by this thread. A client sends one
        # request at a time per connection, but the lock keeps even a
        # misbehaving client's frames whole.
        send_lock = threading.Lock()
        try:
            while not self._stopped.is_set():
                msg = protocol.recv_msg(conn)
                if msg is None:
                    return
                header, arrays = msg
                op = header.get("op", "")
                if op == "ping":
                    with send_lock:
                        protocol.send_msg(conn, {
                            "ok": True, "v": protocol.PROTOCOL_VERSION,
                            "solves": self.solve_calls,
                            "waves": self.waves_served})
                    continue
                if op != "solve":
                    with send_lock:
                        protocol.send_msg(conn, {
                            "err": "SolverProtocolError",
                            "msg": f"unknown op {op!r}"})
                    continue
                self._enqueue_solve(header, arrays, conn, send_lock)
        except (OSError, protocol.SolverProtocolError, ValueError) as e:
            _log.debug("solverd connection dropped: %s", e)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _note_enc(self, header: dict, conn: socket.socket) -> None:
        """Schedulers piggyback their encoder resync counters
        (replay_total, full_total) on the solve header, so the daemon's
        /metrics shows cluster-wide resync health without a second scrape
        target: last-seen values per scheduler, summed."""
        enc = header.get("enc")
        if not (isinstance(enc, (list, tuple)) and len(enc) == 2):
            return
        ch = header.get("cache")
        wid = ch.get("wid") if isinstance(ch, dict) else None
        key = str(wid) if wid is not None else f"conn{id(conn)}"
        try:
            pair = (int(enc[0]), int(enc[1]))
        except (TypeError, ValueError):
            return
        with self._enc_lock:
            self._enc_reported[key] = pair
            rep = sum(p[0] for p in self._enc_reported.values())
            ful = sum(p[1] for p in self._enc_reported.values())
        self._sx.replay_reported.set(rep)
        self._sx.full_reported.set(ful)

    def _enqueue_solve(self, header: dict, arrays: List[np.ndarray],
                       conn: socket.socket,
                       send_lock: threading.Lock) -> None:
        def reject(err: str, msg: str) -> None:
            self._m.requests.inc("error")
            with send_lock:
                protocol.send_msg(conn, {"err": err, "msg": msg})

        def resync(reason: str) -> None:
            # NOT an error: the designed cold-cache/skew answer. The client
            # re-sends the same wave as a full frame.
            self.resync_replies += 1
            self._dm.resyncs.inc(reason)
            with send_lock:
                protocol.send_msg(conn, {"resync": reason})

        v = header.get("v")
        if not (isinstance(v, int) and protocol.MIN_PROTOCOL_VERSION
                <= v <= protocol.PROTOCOL_VERSION):
            reject("SolverProtocolError",
                   f"protocol version skew: daemon speaks "
                   f"{protocol.MIN_PROTOCOL_VERSION}.."
                   f"{protocol.PROTOCOL_VERSION}, request is {v!r}")
            return
        try:
            pol = protocol.policy_from_wire(header["policy"])
        except (KeyError, TypeError, ValueError) as e:
            reject("SolverProtocolError", f"bad policy: {e}")
            return
        gangs = bool(header.get("gangs", False))
        # a v1 client computed its fingerprint with v=1 — derive likewise
        fp = protocol.solver_fingerprint(pol, gangs, version=v)
        if header.get("fp") not in (None, fp):
            reject("SolverProtocolError",
                   f"fingerprint mismatch: request {header.get('fp')!r}, "
                   f"daemon derives {fp!r}")
            return
        self._note_enc(header, conn)

        fields = SolverInputs._fields
        planes = header.get("planes")
        cache_hdr = header.get("cache")
        shipped = sum(a.nbytes for a in arrays)
        cache_key = epoch = None
        new_planes: Dict[str, np.ndarray] = {}
        delta_updates: Dict[str, tuple] = {}
        is_delta = False
        if planes is None:
            # v1-style full frame: every field present, nothing cached
            if len(arrays) != len(fields):
                reject("SolverProtocolError",
                       f"expected {len(fields)} arrays, got {len(arrays)}")
                return
            cols = list(arrays)
        else:
            if len(planes) != len(fields):
                reject("SolverProtocolError",
                       f"expected {len(fields)} plane entries, "
                       f"got {len(planes)}")
                return
            is_delta = any(p != "F" for p in planes)
            entry = None
            if cache_hdr is not None:
                try:
                    cache_key = (str(cache_hdr["wid"]),
                                 str(cache_hdr["bucket"]))
                    epoch = int(cache_hdr.get("epoch", 0))
                except (KeyError, TypeError, ValueError) as e:
                    reject("SolverProtocolError", f"bad cache header: {e}")
                    return
            if is_delta:
                if cache_key is None:
                    reject("SolverProtocolError",
                           "delta planes without a cache header")
                    return
                with self._cache_lock:
                    entry = self._plane_cache.get(cache_key)
                if entry is None:
                    resync("no_cache")
                    return
                if entry["epoch"] != epoch:
                    resync("epoch")
                    return
            it = iter(arrays)
            cols = []
            try:
                for name, p in zip(fields, planes):
                    if p == "F":
                        arr = next(it)
                        if cache_key is not None and \
                                name in protocol.DELTA_FIELDS:
                            # own buffer: cached planes must not pin the
                            # whole receive frame nor alias its reuse
                            arr = np.array(arr, copy=True)
                            new_planes[name] = arr
                        cols.append(arr)
                    elif p == "S":
                        cols.append(entry["planes"][name])
                    elif isinstance(p, list) and len(p) == 2 \
                            and p[0] == "D":
                        rows = next(it)
                        vals = next(it)
                        base = entry["planes"][name]
                        if (rows.ndim != 1 or vals.shape[:1] != rows.shape
                                or vals.shape[1:] != base.shape[1:]
                                or vals.dtype != base.dtype
                                or (rows.size and
                                    (int(rows.max()) >= base.shape[0]
                                     or int(rows.min()) < 0))):
                            resync("shape")
                            return
                        # copy-on-write: queued earlier waves may still
                        # reference the base plane
                        arr = base.copy()
                        arr[rows.astype(np.int64)] = vals
                        new_planes[name] = arr
                        # the mesh executor can replay this as a scatter
                        # when its resident plane still matches `base`
                        delta_updates[name] = (base, rows, vals)
                        cols.append(arr)
                    else:
                        reject("SolverProtocolError",
                               f"bad plane entry {p!r} for {name}")
                        return
            except KeyError:
                resync("missing_plane")
                return
            except StopIteration:
                reject("SolverProtocolError", "truncated delta frame")
                return
            if next(it, None) is not None:
                reject("SolverProtocolError", "trailing arrays in frame")
                return
        inp = SolverInputs(*cols)
        req = _Req(inp, pol, gangs, int(inp.req.shape[0]), conn, send_lock,
                   cache_key=cache_key, delta=delta_updates or None,
                   trace=protocol.parse_trace(header))
        with self._cond:
            busy = len(self._pending) >= self.max_queue
            if not busy:
                self._pending.append(req)
                self._m.queue_depth.set(len(self._pending))
                self._cond.notify()
        if busy:
            # cache deliberately untouched: the client will not advance
            # its mirror for a bounced wave, so both sides stay at the
            # pre-frame epoch
            self._m.requests.inc("busy")
            with send_lock:
                protocol.send_msg(conn, {"busy": True})
            return
        self._dm.bytes_shipped.inc(by=shipped)
        self._dm.bytes_saved.inc(
            by=max(0, sum(c.nbytes for c in cols) - shipped))
        if is_delta:
            self.delta_waves += 1
            self._dm.hits.inc()
        else:
            self._dm.full_frames.inc()
        if cache_key is not None:
            with self._cache_lock:
                prev = self._plane_cache.pop(cache_key, None)
                merged = dict(prev["planes"]) if prev else {}
                merged.update(new_planes)
                self._plane_cache[cache_key] = {
                    "epoch": (epoch or 0) + 1, "planes": merged}
                while len(self._plane_cache) > self.cache_entries:
                    self._plane_cache.popitem(last=False)
                self._dm.cache_entries.set(len(self._plane_cache))

    # -- solver side -------------------------------------------------------
    def _gather(self) -> List[_Req]:
        """Block for the first request (or a prewarm job: then return
        empty), then keep gathering until the window closes or the batch
        is full."""
        with self._cond:
            while not self._pending and not self._prewarm_jobs \
                    and not self._stopped.is_set():
                self._cond.wait(0.1)
            if self._stopped.is_set() or not self._pending:
                return []
            batch = [self._pending.popleft()]
        deadline = time.monotonic() + self.gather_window_s
        while len(batch) < self.max_batch:
            with self._cond:
                while self._pending and len(batch) < self.max_batch:
                    batch.append(self._pending.popleft())
                if len(batch) >= self.max_batch:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopped.is_set():
                    break
                self._cond.wait(remaining)
        with self._cond:
            self._m.queue_depth.set(len(self._pending))
        return batch

    def _solve_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stopped.is_set():
            self._run_prewarm_jobs()
            batch = self._gather()
            if not batch:
                continue
            self._m.occupancy.observe(len(batch) / self.max_batch)
            groups: Dict[tuple, List[_Req]] = {}
            for r in batch:
                key = (r.pol, r.gangs, str(r.inp.cap.dtype),
                       r.inp.node_aff_vals.shape[1],
                       r.inp.zone_idx.shape[0])
                groups.setdefault(key, []).append(r)
            for reqs in groups.values():
                try:
                    self._solve_group(reqs)
                except Exception as e:  # noqa: BLE001 — must answer anyway
                    _log.exception("batched solve failed (%d waves)",
                                   len(reqs))
                    self._m.requests.inc("error")
                    for r in reqs:
                        try:
                            with r.send_lock:
                                protocol.send_msg(r.conn, {
                                    "err": type(e).__name__, "msg": str(e)})
                        except OSError:
                            pass

    def _device_solve(self, stacked, pol: BatchPolicy, gangs: bool
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """One device call over a group stacked on a leading batch axis
        (numpy SolverInputs, every wave padded to one shape) -> (chosen,
        scores) int32 [k, P], one readback. The waves inside the kernel's
        domain run as one launch of ``solve_commit_batch``, one block
        each; the others run ``solve_scan`` one by one. The padding adds
        zero peers, so each wave's peer bound is its own. Overridable seam
        (tests inject slow fakes to drive backpressure)."""
        k = int(stacked.cap.shape[0])
        items = [SolverInputs(*(c[i] for c in stacked)) for i in range(k)]
        shipped = [ship_inputs(it, self.device) for it in items]
        kernel = [i for i in range(k)
                  if commit_solver.eligible(items[i], pol,
                                            peer_bound_of(items[i]))]
        out: List[Optional[tuple]] = [None] * k
        if kernel:
            cis = [commit_solver.prepare(shipped[i], pol, gangs)
                   for i in kernel]
            for i, res in zip(kernel,
                              commit_solver.solve_commit_batch(cis)):
                out[i] = res
            self.batched_solves += 1
        for i in range(k):
            if out[i] is None:
                out[i] = solve_scan(shipped[i], pol, gangs)
                self.scan_waves += 1
        both = torch.stack([torch.stack([c for c, _ in out]),
                            torch.stack([s for _, s in out])]).cpu().numpy()
        return both[0], both[1]

    # -- prewarm (solver/prewarm.py) ----------------------------------------
    def _prewarm_compile(self, target: Dict[str, int]) -> None:
        """Prewarm-thread work for one bucket. The kernel has no per-shape
        compile: what a bucket needs is the library (built once per source
        hash) and the first launch of each kernel instance. So the latest
        exemplar wave is handed to the solver thread at its OWN shape,
        never padded to the bucket (that would solve pod-node pairs no live
        group has, and could move a north_star wave's state out of shared
        memory onto an instance live groups never take): alone, or stacked
        twice when the bucket's BATCH is 2 or more, for the batched
        instance. The solver thread launches it only if that instance has
        not launched in this process yet. An exemplar outside the kernel's
        domain launches nothing (the plain version needs no warm-up)."""
        ex = self._prewarm_exemplar
        if ex is None:
            raise RuntimeError("no exemplar wave to launch")
        inp, pol, gangs = ex
        if not commit_solver.eligible(inp, pol, peer_bound_of(inp)):
            return
        batch = 2 if int(target.get("BATCH", 1)) > 1 else 1
        job = _PrewarmJob(type(inp)(*(np.stack([c] * batch) for c in inp)),
                          pol, gangs)
        with self._cond:
            self._prewarm_jobs.append(job)
            self._cond.notify()
        while not job.done.wait(0.25):
            if self._stopped.is_set():
                return  # shutting down: the launch no longer matters
        if job.error is not None:
            raise job.error

    def _run_prewarm_jobs(self) -> None:
        """Solver thread: run the prewarm launches queued since the last
        group, between live groups, skipping a job whose instance this
        process has launched already."""
        while True:
            with self._cond:
                job = self._prewarm_jobs.popleft() \
                    if self._prewarm_jobs else None
            if job is None:
                return
            try:
                t0 = time.perf_counter()
                if self._instance_launched(job):
                    self.prewarm_skipped += 1
                else:
                    self._device_solve(job.stacked, job.pol, job.gangs)
                    self.prewarm_launches += 1
                self.prewarm_s += time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 — the prewarm thread
                # logs and counts it; the live path is unaffected
                job.error = e
            job.done.set()

    def _instance_launched(self, job: _PrewarmJob) -> bool:
        """Whether the kernel instance a prewarm job would launch has
        launched in this process already, read off the exemplar's shapes
        (never on the CPU, where the job runs the plain version as a live
        group would)."""
        if self.device.type != "cuda":
            return False
        first = SolverInputs(*(c[0] for c in job.stacked))
        return commit_solver.instance_for(
            first, job.pol, job.gangs, int(job.stacked.cap.shape[0])
        ) in commit_solver.solve_commit.instances

    def _prewarm_boot(self) -> None:
        """--prewarm boot mode: queue the buckets implied by the declared
        cluster size (--prewarm-nodes/-pods/-batch) before the first
        request arrives, with a synthetic exemplar wave (64cpu/256Gi nodes,
        100m/128Mi pods, default policy). The boot set arms the
        compile_prewarm_ready gauge that load windows gate on."""
        from kubernetes_tpu_torch.api import types as api
        from kubernetes_tpu_torch.api.quantity import Quantity

        nodes_hint, pods_hint, batch_hint = self._boot_hints
        try:
            floor = min(64, max(1, pods_hint))
            node = api.Node(
                metadata=api.ObjectMeta(name="prewarm-node"),
                spec=api.NodeSpec(capacity={
                    "cpu": Quantity("64"), "memory": Quantity("256Gi")}))
            res = api.ResourceRequirements(limits={
                "cpu": Quantity("100m"), "memory": Quantity("128Mi")})
            pods = [api.Pod(
                metadata=api.ObjectMeta(name=f"prewarm-{i}",
                                        namespace="default"),
                spec=api.PodSpec(containers=[api.Container(
                    name="c", image="img", resources=res)]))
                for i in range(floor)]
            snap = encode_snapshot([node], [], pods, [],
                                   policy=BatchPolicy())
            host = snapshot_to_host_inputs(snap)
        except Exception:  # noqa: BLE001 — boot readiness must not wedge
            _log.exception("prewarm boot: synthetic exemplar failed")
            self._prewarm.boot_set([])
            return
        if self._prewarm_exemplar is None:
            self._prewarm_exemplar = (host, BatchPolicy(), False)
        dims = _dims_of(host)
        n_target = _pow2_pad(max(int(nodes_hint), dims["N"]), minimum=1)
        batches = sorted({1, _pow2_pad(max(1, int(batch_hint)),
                                       minimum=1)})
        targets = []
        for p in pow2_ladder(pods_hint, floor=256) or [dims["P"]]:
            for b in batches:
                t = dict(dims)
                t["N"] = n_target
                t["N1"] = n_target + 1
                t["P"] = max(p, dims["P"])
                t["BATCH"] = b
                targets.append(t)
        self._prewarm.boot_set(targets)

    @staticmethod
    def _trace_group(reqs: List[_Req], t0_ns: int, end_ns: int,
                     mesh: bool = False) -> None:
        """Attach the daemon's per-wave spans (queue wait + batched
        solve) to each requesting wave's trace — the cross-process leg
        of the wave timeline. No-op unless the daemon runs with --trace
        AND the frame carried a v3 trace context."""
        if not tracing.enabled():
            return
        for r in reqs:
            if r.trace is None:
                continue
            tracing.record("solverd.queue", r.t_enq, t0_ns, parent=r.trace)
            tracing.record("solverd.solve", t0_ns, end_ns, parent=r.trace,
                           coalesced=len(reqs), mesh=mesh, pods=r.p,
                           nodes=int(r.inp.cap.shape[0]))

    def _solve_mesh(self, r: _Req) -> None:
        """One wave through the mesh executor, from its resident planes,
        and its reply."""
        pol, gangs = r.pol, r.gangs
        me = self._mesh_exec
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        if r.trace is not None and tracing.enabled():
            # ambient install so the executor's plane/device sub-spans
            # attach to this wave's trace
            with tracing.span("solverd.mesh", parent=r.trace):
                chosen, scores = me.solve(r.inp, pol, gangs,
                                          cache_key=r.cache_key,
                                          delta=r.delta)
        else:
            chosen, scores = me.solve(r.inp, pol, gangs,
                                      cache_key=r.cache_key, delta=r.delta)
        dt = time.perf_counter() - t0
        self._trace_group([r], t0_ns, time.monotonic_ns(), mesh=True)
        self.solve_calls += 1
        self.waves_served += 1
        self._m.solves.inc()
        self._m.waves.inc()
        self._m.batch.observe(1)
        self._m.solve_s.observe(dt)
        self._m.requests.inc("ok")
        try:
            with r.send_lock:
                protocol.send_msg(
                    r.conn, {"ok": True, "coalesced": 1},
                    (np.ascontiguousarray(chosen[:r.p]),
                     np.ascontiguousarray(scores[:r.p])))
        except OSError:
            _log.debug("requester went away before its reply")

    def _solve_group(self, reqs: List[_Req]) -> None:
        pol, gangs = reqs[0].pol, reqs[0].gangs
        # kernel-vs-mesh dispatch: a single-wave group the mesh executor
        # takes (above its node floor, and on a card beyond the kernel's
        # domain) solves from device-resident shards at its exact shape;
        # coalesced groups and the kernel's waves keep the batched launch
        me = self._mesh_exec
        if me is not None and len(reqs) == 1 \
                and me.eligible(reqs[0].inp, pol, gangs):
            self._solve_mesh(reqs[0])
            return
        all_dims = [_dims_of(r.inp) for r in reqs]
        target = _target_dims(all_dims)
        padded = [_pad_inputs(r.inp, target) for r in reqs]
        # the prewarm fill trigger: this group's true occupancy against
        # the pow-2 bucket it falls in (and the batch axis), so the next
        # bucket's exemplar launches off this loop before growth reaches it
        self._prewarm_exemplar = (reqs[0].inp, pol, gangs)
        actual = dict(target)
        actual["BATCH"] = len(reqs)
        bucket = _bucket_dims(target)
        bucket["BATCH"] = _pow2_pad(len(reqs), minimum=1)
        frozen = ("R", "L", "A")
        if bucket["BATCH"] >= _pow2_pad(self.max_batch, minimum=1):
            frozen += ("BATCH",)  # gather never fills past max_batch
        self._prewarm.observe(actual, bucket, frozen=frozen)
        stacked = type(padded[0])(*(np.stack(cols)
                                    for cols in zip(*padded)))
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        chosen, scores = self._device_solve(stacked, pol, gangs)
        dt = time.perf_counter() - t0
        self._trace_group(reqs, t0_ns, time.monotonic_ns())
        self.solve_calls += 1
        self.waves_served += len(reqs)
        self._m.solves.inc()
        self._m.waves.inc(by=len(reqs))
        self._m.batch.observe(len(reqs))
        self._m.solve_s.observe(dt)
        for i, r in enumerate(reqs):
            self._m.requests.inc("ok")
            try:
                with r.send_lock:
                    protocol.send_msg(
                        r.conn,
                        {"ok": True, "coalesced": len(reqs)},
                        (np.ascontiguousarray(chosen[i, :r.p]),
                         np.ascontiguousarray(scores[i, :r.p])))
            except OSError:
                _log.debug("requester went away before its reply")
