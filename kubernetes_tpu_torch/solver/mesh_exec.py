"""MeshExecutor — the device-mesh solve inside kube-solverd.

Port of ``kubernetes_tpu/solver/mesh_exec.py``. The daemon's resident
plane cache (the delta wire's reconstruction target, solver/service.py)
gains a device half: the node, group and zone planes live on the mesh as
per-shard tensors laid out by ``parallel.mesh.place_plane``, and
consecutive waves of one (worker, shape bucket) pair touch the device
only O(changed rows + pod planes) per wave:

- **identity-anchored residency**: the service's copy-on-write delta
  reconstruction means an unchanged plane is the SAME numpy object wave
  to wave — the executor keys its device planes on that object identity,
  so an "S" plane costs zero transfer and zero reshard;
- **deltas scatter into the resident shard tensors**: a changed plane
  arrives as (base, rows, vals); when the resident plane matches ``base``
  by identity, each shard's rows are written in place with ``index_copy_``
  and only the rows cross the host boundary. The resident tensors are the
  executor's own copies (``place_plane`` never aliases a host array), so
  the in-place write touches no plane the service or a queued wave holds;
- **exact-shape solves**: waves run at the client's resident shape padded
  only to the mesh's node multiple (``pad_inputs_for_mesh``);
- **an LRU of resident planes**, with the bytes moved per wave split into
  transfers (deltas, pod planes, first contact) and reshards (residency
  lost and re-established), which back-to-back waves keep at zero.

**Dispatch is a measured crossover.** With ``dispatch="auto"`` the
executor times the sharded loop against the single-device layout (the
1x1 submesh) once per (device type, device count, pods_axis, plane shape)
— the probe doubles as a bit-identity check — runs the winner, and
persists the calibration (``util/warmstart.mesh_cal_path``) so restarts
skip the probe; a divergent probe pins ``single``. ``"shard"`` forces the
full mesh, ``"single"`` the 1x1 submesh. On the single-device layout a
wave may first compact its node axis (models/submesh.py).

Decisions are bit-identical to the single-device and serial paths, and
the executor keeps that claim live: the first mesh wave of a run (and
every wave under ``probe="all"``) is re-solved in the other layout and
compared bitwise, counted in ``solverd_mesh_parity_*``; a compacted wave
is re-solved on the full plane (``solverd_submesh_parity_*``).

Left out, as they exist only for XLA: buffer donation (the reference's
``_donation_warnings_scoped`` and the donating scatter) and
``_pow2_rows``, which bucketed a delta's row count to bound XLA's
compiled scatter programs.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.util import metrics, tracing, warmstart

__all__ = ["MeshExecutor"]

_log = logging.getLogger("kubernetes_tpu_torch.solver.mesh_exec")


class _Plane:
    """One resident plane on the mesh: a tensor per node shard (shards on
    one device share a replicated plane's tensor)."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = tuple(shards)

    def distinct(self):
        seen: dict = {}
        for t in self.shards:
            seen.setdefault(id(t), t)
        return list(seen.values())

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.distinct())


class MeshExecutor:
    """Owns the mesh, the dispatch calibration, and the device-resident
    plane cache. One instance per SolverService; all device work happens
    on the daemon's single solver thread. ``devices`` names the mesh's
    devices (default: every CUDA device); a device may repeat."""

    def __init__(self, pods_axis: int = 1,
                 min_nodes: Optional[int] = None,
                 dispatch: str = "auto",
                 probe: str = "first",
                 cache_entries: int = 64,
                 devices=None):
        from kubernetes_tpu_torch.parallel import mesh as pm

        if dispatch not in ("auto", "shard", "single"):
            raise ValueError(
                f"mesh dispatch={dispatch!r}: expected auto|shard|single")
        if probe not in ("first", "all", "off"):
            raise ValueError(
                f"mesh probe={probe!r}: expected first|all|off")
        self.mesh = pm.make_mesh(devices, pods_axis=pods_axis)
        self.submesh = pm.make_mesh(self.mesh.devices[0][:1], pods_axis=1)
        self.pods_axis = pods_axis
        self.min_nodes = (pm.DEFAULT_MESH_MIN_NODES
                          if min_nodes is None else int(min_nodes))
        self.dispatch = dispatch
        self.probe = probe
        self.cache_entries = cache_entries
        self._pm = pm
        # (wid, bucket) -> {"mesh": Mesh, "planes": {name: (src, _Plane)}};
        # src is the host numpy object, the identity chain's anchor
        self._resident: "OrderedDict[tuple, dict]" = OrderedDict()
        self._resident_bytes = 0
        # keys whose residency was LRU-evicted: their next wave's full
        # re-transfer counts as reshard (lost residency), not cold
        # first-contact transfer. Cleared when it outgrows the cache
        # several times over (stale entries only ever over-report).
        self._evicted: set = set()
        self._cal: Dict[str, dict] = {}
        self._cal_lock = threading.Lock()
        self._probed_once = False
        self._submesh_probed = False
        self._m = metrics.solverd_mesh_metrics()
        self._sm = metrics.solverd_submesh_metrics()
        self._m.devices.set(self.mesh.size)
        self._m.pods_axis.set(pods_axis)
        self._load_cal()
        # exposed for tests and the startup banner
        self.mesh_waves = 0
        self.parity_checks = 0
        self.parity_divergent = 0
        self.submesh_waves = 0
        self.submesh_parity_divergent = 0

    # -- calibration persistence (warm start, keyed by mesh shape) ---------
    def _load_cal(self) -> None:
        if not warmstart.enabled():
            return
        try:
            with open(warmstart.mesh_cal_path()) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return
        if isinstance(data, dict) and data.get("v") == 1 \
                and isinstance(data.get("cals"), dict):
            self._cal.update(data["cals"])

    def _save_cal(self) -> None:
        if not warmstart.enabled():
            return
        path = warmstart.mesh_cal_path()
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with self._cal_lock:
                blob = json.dumps({"v": 1, "cals": self._cal})
            with open(tmp, "w") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        except OSError as e:
            _log.warning("mesh calibration not saved to %s: %s", path, e)

    def _cal_key(self, inp, pol, gangs: bool) -> str:
        from kubernetes_tpu_torch.solver import protocol
        fp = protocol.solver_fingerprint(pol, bool(gangs))[:8]
        return (f"{self.mesh.node_devices[0].type}x{self.mesh.size}"
                f"|pods_axis{self.pods_axis}"
                f"|N{inp.cap.shape[0]}|P{inp.req.shape[0]}"
                f"|R{inp.cap.shape[1]}|{np.dtype(inp.cap.dtype).str}|{fp}")

    # -- eligibility --------------------------------------------------------
    def eligible(self, inp, pol, gangs: bool) -> bool:
        """Kernel-vs-mesh, the daemon half: waves below the node floor,
        and on a CUDA mesh the waves inside the commit_solve kernel's
        domain (``commit_solver.eligible``: up to 65,536 nodes, 1,024
        groups and 32 bands, peer totals below 2^24), keep the daemon's
        coalesced single-device path (one kernel launch). Everything else
        takes the mesh executor."""
        if int(inp.cap.shape[0]) < self.min_nodes:
            return False
        from kubernetes_tpu_torch.models.batch_solver import peer_bound_of
        from kubernetes_tpu_torch.models.policy import BatchPolicy
        from kubernetes_tpu_torch.ops import commit_solver
        if self.mesh.node_devices[0].type == "cuda" and \
                commit_solver.eligible(inp, pol or BatchPolicy(),
                                       peer_bound_of(inp)):
            return False
        return True

    @property
    def node_shards(self) -> int:
        return int(self.mesh.shape["nodes"])

    # -- the solve ----------------------------------------------------------
    def _active_mesh(self, inp, pol, gangs: bool):
        """The layout this wave runs under, probing the crossover once
        per calibration key when dispatch is auto. Returns
        (mesh, probe_result_or_None): a probe already solved the wave in
        both layouts, so its winner's answer is returned for reuse."""
        if self.dispatch == "single":
            return self.submesh, None
        if self.dispatch == "shard" or self.node_shards == 1:
            return self.mesh, None
        key = self._cal_key(inp, pol, gangs)
        with self._cal_lock:
            cal = self._cal.get(key)
        if cal is not None:
            return (self.mesh if cal.get("winner") == "shard"
                    else self.submesh), None
        single_res, single_s = self._time_layout(self.submesh, inp, pol,
                                                 gangs)
        shard_res, shard_s = self._time_layout(self.mesh, inp, pol, gangs)
        divergent = not (np.array_equal(single_res[0], shard_res[0])
                         and np.array_equal(single_res[1], shard_res[1]))
        # this probe IS a bitwise both-layouts comparison: the separate
        # first-wave parity probe would only repeat it
        self._probed_once = True
        self.parity_checks += 1
        self._m.parity_checks.inc()
        self._m.single_probe_s.observe(single_s)
        if divergent:
            # must never happen (the bit-identity contract); refuse to
            # cache a winner and serve the single-device answer
            self.parity_divergent += 1
            self._m.parity_divergent.inc()
            _log.error("mesh dispatch probe DIVERGED at %s "
                       "(sharded != single-device); pinning single", key)
            return self.submesh, single_res
        winner = "shard" if shard_s < single_s else "single"
        with self._cal_lock:
            self._cal[key] = {"winner": winner,
                              "sharded_s": round(shard_s, 4),
                              "single_s": round(single_s, 4)}
        self._save_cal()
        _log.info("mesh dispatch probe %s: sharded %.3fs vs single %.3fs "
                  "-> %s", key, shard_s, single_s, winner)
        return (self.mesh if winner == "shard" else self.submesh), (
            shard_res if winner == "shard" else single_res)

    def _time_layout(self, mesh, inp, pol, gangs: bool):
        """One full placed solve in ``mesh``'s layout -> (result, seconds
        of the solve alone). Nothing is compiled, so one run is the
        steady cost the dispatch decision is about."""
        pm = self._pm
        padded, _n = pm.pad_inputs_for_mesh(inp, mesh)
        res = pm.place_inputs(padded, mesh, pm.RESIDENT_FIELDS)
        wav = pm.place_inputs(padded, mesh, pm.WAVE_FIELDS)
        fn = pm.sharded_program(mesh, pol, gangs)
        t0 = time.perf_counter()
        chosen, scores = fn(res, wav)
        both = torch.stack([chosen, scores]).cpu().numpy()
        return (both[0], both[1]), time.perf_counter() - t0

    def solve(self, inp, pol, gangs: bool, cache_key: Optional[tuple] = None,
              delta: Optional[dict] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Solve one wave from (mostly) device-resident planes.

        ``inp`` is the service's reconstructed host-side SolverInputs;
        ``cache_key`` is the delta-wire (wid, bucket) pair the resident
        device planes are keyed under (None = no residency, e.g. a v1
        client); ``delta`` maps field name -> (base, rows, vals) for
        planes this wave changed, enabling the on-device scatter when the
        resident plane matches ``base``."""
        t_wave = time.perf_counter()
        # the service's mesh path installs the wave's ambient span before
        # calling in; tctx None = untraced
        tctx = tracing.current()
        t_pl0 = time.monotonic_ns()
        mesh, probed = self._active_mesh(inp, pol, gangs)
        self.mesh_waves += 1
        self._m.waves.inc()
        self._m.node_shards.set(mesh.shape["nodes"])
        pm = self._pm
        pad = int(pm._pad_width(int(inp.cap.shape[0]), mesh.shape["nodes"]))
        transfer = 0
        reshard = 0
        was_new = cache_key is not None and cache_key not in self._resident
        entry = self._resident.get(cache_key) if cache_key else None
        # freed covers the entry as it WAS, so a layout flip (same key
        # rebuilt under the other mesh) can't leak resident_bytes upward
        freed = sum(rec[1].nbytes for rec in entry["planes"].values()) \
            if entry is not None else 0
        lost_layout = entry is not None and entry["mesh"] is not mesh
        # residency lost wholesale (layout flip, or this key was LRU-
        # evicted since its last wave): every re-establish below is
        # reshard traffic, not cold first-contact transfer
        lost_residency = lost_layout or (was_new
                                         and cache_key in self._evicted)
        if entry is None or lost_layout:
            entry = {"mesh": mesh, "planes": {}}
        resident_dev = []
        for name in pm.RESIDENT_FIELDS:
            cur = getattr(inp, name)
            rec = entry["planes"].get(name)
            if rec is not None and rec[0] is cur:
                resident_dev.append(rec[1])
                continue
            d = delta.get(name) if delta else None
            if rec is not None and d is not None and d[0] is rec[0]:
                plane = rec[1]
                transfer += self._scatter(name, plane, d[1], d[2], pad)
            else:
                # one plane padded host-side (PAD_SPEC) and placed: only
                # THIS plane is re-established
                arr = pm.pad_plane(name, cur, pad)
                plane = _Plane(pm.place_plane(name, arr, mesh))
                transfer += arr.nbytes
                if rec is not None or lost_residency:
                    # had residency, lost the identity chain (out-of-order
                    # base, eviction, layout flip): the cost this path
                    # must keep near zero between back-to-back waves
                    reshard += arr.nbytes
            entry["planes"][name] = (cur, plane)
            resident_dev.append(plane)
        if cache_key is not None:
            self._resident[cache_key] = entry
            self._resident.move_to_end(cache_key)
            self._evicted.discard(cache_key)
            self._resident_bytes += sum(
                rec[1].nbytes for rec in entry["planes"].values()) - freed
            while len(self._resident) > self.cache_entries:
                _k, old = self._resident.popitem(last=False)
                if len(self._evicted) > 16 * self.cache_entries:
                    self._evicted.clear()
                self._evicted.add(_k)
                self._resident_bytes -= sum(
                    rec[1].nbytes for rec in old["planes"].values())
            self._m.resident_bytes.set(self._resident_bytes)
            if was_new:
                # once per bucket: the per-device footprint evidence
                self.memory_report(inp)
        if probed is not None:
            # the dispatch probe already solved this wave in BOTH layouts
            # (and compared them bitwise); residency was still installed
            # above so the NEXT wave rides the identity chain
            self._m.transfer_bytes.inc(by=transfer)
            self._m.reshard_bytes.inc(by=reshard)
            return probed
        # active sub-mesh (models/submesh.py): on the single-device
        # layout, compact the node axis to the nodes that could possibly
        # place this wave before the loop; a gather on the resident
        # planes' device, so residency and the delta chain are untouched
        plan = None
        zone_bf16 = False
        if int(mesh.shape["nodes"]) == 1:
            from kubernetes_tpu_torch.models import submesh as sm
            t_k0 = time.perf_counter()
            plan = sm.plan_wave(inp, pol)
            if plan is not None:
                self._sm.compact_s.observe(time.perf_counter() - t_k0)
                self._sm.waves.inc()
                self._sm.nodes_kept.inc(by=plan.n_kept)
                self._sm.nodes_total.inc(by=plan.n_total)
                self.submesh_waves += 1
                zone_bf16 = sm.zone_bf16_ok(inp, pol)
            else:
                self._sm.full_waves.inc()
        wave_dev = []
        for name in pm.WAVE_FIELDS:
            arr = getattr(inp, name)
            if plan is not None and name == "pod_host_idx":
                # host pins move to compact indices host-side (pinned
                # nodes are kept by construction, so no pin is lost)
                arr = sm.remap_pod_host_idx(arr, plan)
            wave_dev.append(pm.place_plane(name, arr, mesh))
            transfer += arr.nbytes
        if tctx is not None:
            tracing.record("mesh.planes", t_pl0, time.monotonic_ns(),
                           parent=tctx, transfer=transfer, reshard=reshard)
        t_dv0 = time.monotonic_ns()
        if plan is not None:
            fn = sm.submesh_program(pol, gangs, zone_bf16)
            chosen, scores = fn(tuple(p.shards[0] for p in resident_dev),
                                tuple(w[0] for w in wave_dev),
                                plan.keep_idx, plan.valid)
        else:
            fn = pm.sharded_program(mesh, pol, gangs)
            chosen, scores = fn(tuple(p.shards for p in resident_dev),
                                tuple(wave_dev))
        both = torch.stack([chosen, scores]).cpu().numpy()
        if tctx is not None:
            tracing.record("mesh.device_solve", t_dv0, time.monotonic_ns(),
                           parent=tctx,
                           node_shards=int(mesh.shape["nodes"]),
                           submesh=plan.n_kept if plan is not None else 0)
        self._m.transfer_bytes.inc(by=transfer)
        self._m.reshard_bytes.inc(by=reshard)
        self._m.solve_s.observe(time.perf_counter() - t_wave)
        out = (both[0], both[1])
        if plan is not None and (self.probe == "all"
                                 or not self._submesh_probed):
            self._submesh_probed = True
            self._submesh_parity_probe(inp, pol, gangs, mesh, out)
        if self.probe == "all" or (self.probe == "first"
                                   and not self._probed_once):
            self._probed_once = True
            self._parity_probe(inp, pol, gangs, mesh, out)
        return out

    def _scatter(self, name: str, plane: _Plane, rows, vals,
                 pad: int) -> int:
        """Apply one plane's row delta to its resident shard tensors in
        place -> the bytes that crossed the host boundary. ``rows`` index
        the plane's first axis: node rows for a node-major plane (each
        shard takes the rows inside its slice), label or group rows for
        ``zone_idx`` and ``group_counts`` (whose values span the node
        axis: padded to the resident width, then sliced per shard), and
        the rows of a replicated plane (written on each distinct
        tensor)."""
        rows = np.asarray(rows).astype(np.int64)
        vals = np.ascontiguousarray(vals)
        moved = rows.nbytes + vals.nbytes
        axis = self._pm.NODE_AXIS.get(name)

        def on(a, dev):
            return self._pm.as_tensor(a).to(dev)
        if axis == 0:
            lo = 0
            for t in plane.shards:
                n = t.shape[0]
                sel = (rows >= lo) & (rows < lo + n)
                if sel.any():
                    t.index_copy_(0, on(rows[sel] - lo, t.device),
                                  on(vals[sel], t.device))
                lo += n
            return moved
        if axis == 1:
            vals = self._pm.pad_plane(name, vals, pad)
            lo = 0
            for t in plane.shards:
                if name == "group_counts":
                    n = t.shape[1] - 1
                    part = np.concatenate([vals[:, lo:lo + n], vals[:, -1:]],
                                          axis=1)
                else:
                    n = t.shape[1]
                    part = vals[:, lo:lo + n]
                t.index_copy_(0, on(rows, t.device), on(part, t.device))
                lo += n
            return moved
        for t in plane.distinct():
            t.index_copy_(0, on(rows, t.device), on(vals, t.device))
        return moved

    def _submesh_parity_probe(self, inp, pol, gangs, mesh, out) -> None:
        """Re-solve a compacted wave on the FULL node plane (same mesh,
        no compaction) and compare bitwise — the live evidence that the
        keep rule and the index remap changed the layout and nothing
        else. Runs on the first submesh wave of a run, every wave under
        probe='all'; never under probe='off'."""
        if self.probe == "off":
            return
        res, _t = self._time_layout(mesh, inp, pol, gangs)
        self._sm.parity_checks.inc()
        if not (np.array_equal(res[0], out[0])
                and np.array_equal(res[1], out[1])):
            self.submesh_parity_divergent += 1
            self._sm.parity_divergent.inc()
            _log.error("submesh parity probe DIVERGED: compacted vs full "
                       "plane — keep rule or remap violated bit-identity")

    def _parity_probe(self, inp, pol, gangs, active_mesh, out) -> None:
        """Re-solve the same wave in the OTHER layout (single-device
        submesh, or the full mesh when the active layout already is the
        submesh) and compare bitwise — the live evidence behind the
        'layout changes, decisions do not' contract."""
        other = self.submesh if active_mesh is not self.submesh else self.mesh
        res, t = self._time_layout(other, inp, pol, gangs)
        self.parity_checks += 1
        self._m.parity_checks.inc()
        self._m.single_probe_s.observe(t)
        if not (np.array_equal(res[0], out[0])
                and np.array_equal(res[1], out[1])):
            self.parity_divergent += 1
            self._m.parity_divergent.inc()
            _log.error("mesh parity probe DIVERGED: %s vs %s layout",
                       active_mesh.shape, other.shape)

    def memory_report(self, inp) -> dict:
        """shard_memory_report under the full mesh, surfaced to the
        ``solverd_mesh_shard_bytes_per_device`` gauge."""
        rep = self._pm.shard_memory_report(inp, self.mesh)
        self._m.shard_bytes_per_device.set(rep["total_bytes_per_device"])
        return rep
