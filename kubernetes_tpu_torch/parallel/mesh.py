"""The device mesh and the node-sharded wave solve.

Port of ``kubernetes_tpu/parallel/mesh.py``. A ``Mesh`` is a ("pods",
"nodes") grid of torch devices. A wave's node planes split over the
"nodes" axis into equal contiguous slices, one per shard, in node order;
the commit loop runs over those shards with every node-axis reduction made
across them (``parallel/sharded_scan.py``). The "pods" axis replicates, as
in the reference, where no pod plane is sharded: the loop runs on the
grid's first row.

The reference is single-controller: one process owns every device and the
SPMD partitioner inserts the collectives. The port keeps that design: one
process holds the shards, and a cross-shard reduction is a gather of small
tensors onto the first shard's device, a reduction there, and a copy back.
A device may repeat in the grid, so four shards on ``cuda:0`` (or eight on
``cpu``) form a valid mesh: the counterpart of the reference's
``--xla_force_host_platform_device_count``.

Nodes are padded to a multiple of the shard count with nodes that can
never be chosen (``PAD_SPEC``), at the end of the whole node axis, so the
shard order is the node order and padding never wins the FNV-1a
tie-break: decisions stay bit-identical to the single-device and serial
solves. The off-list column of ``group_counts`` stays its last column
after padding, and every shard holds it.

Left out, as it exists only for XLA: buffer donation (``sharded_program``
takes no ``donate``); there is no compile, so nothing is cached per mesh.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.models.batch_solver import (
    SolverInputs,
    peer_bound_of,
    solve_device,
)
from kubernetes_tpu_torch.ops import commit_solver

__all__ = ["Mesh", "MeshUnavailable", "default_devices", "make_mesh",
           "maybe_mesh", "pad_inputs_for_mesh", "pad_plane", "place_plane",
           "as_tensor",
           "place_inputs", "solve_sharded", "shard_memory_report",
           "sharded_program", "input_shardings", "RESIDENT_FIELDS",
           "WAVE_FIELDS", "DEFAULT_MESH_MIN_NODES", "PAD_SPEC"]

_DEBUG = os.environ.get("KTPU_DEBUG", "") not in ("", "0")

# Below this node count the mesh dispatch stays out of the way by default:
# small waves are kernel or single-device territory.
DEFAULT_MESH_MIN_NODES = 4096

# The resident/wave split of SolverInputs, shared with the solver daemon's
# delta wire (solver/protocol.DELTA_FIELDS names the same set): node,
# group and zone planes persist between waves (device-resident under the
# mesh executor), pod-axis planes are new every wave.
RESIDENT_FIELDS = (
    "cap", "advertises", "fit_used", "fit_exceeded", "score_used",
    "node_ports", "node_sel", "node_pds", "node_extra_ok",
    "group_counts", "score_static", "node_aff_vals",
    "zone_idx", "zone_counts0",
    "evict_cap", "evict_cnt", "band_prio",
)
WAVE_FIELDS = tuple(f for f in SolverInputs._fields
                    if f not in RESIDENT_FIELDS)

# The node axis of each plane that shards over "nodes"; every other plane
# is replicated. group_counts shards its node columns and replicates its
# last, off-list column (each shard's slice keeps it last).
NODE_AXIS = {
    "cap": 0, "advertises": 0, "fit_used": 0, "fit_exceeded": 0,
    "score_used": 0, "node_ports": 0, "node_sel": 0, "node_pds": 0,
    "node_extra_ok": 0, "score_static": 0, "node_aff_vals": 0,
    "group_counts": 1, "zone_idx": 1, "evict_cap": 0, "evict_cnt": 0,
}


class MeshUnavailable(RuntimeError):
    """``--mesh on`` on a host without more than one device."""


class Mesh:
    """A ("pods", "nodes") grid of torch devices. ``shape`` maps each axis
    name to its length; ``node_devices`` is the first row, the devices the
    node shards live on, in shard order. A device may repeat."""

    def __init__(self, devices: Sequence, pods_axis: int = 1):
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        if n == 0:
            raise ValueError("a mesh needs at least one device")
        if pods_axis < 1 or n % pods_axis != 0:
            raise ValueError(
                f"{n} devices not divisible by pods_axis={pods_axis}")
        cols = n // pods_axis
        self.devices = tuple(tuple(devices[r * cols:(r + 1) * cols])
                             for r in range(pods_axis))
        self.shape: Dict[str, int] = {"pods": pods_axis, "nodes": cols}

    @property
    def node_devices(self) -> Tuple[torch.device, ...]:
        return self.devices[0]

    @property
    def size(self) -> int:
        return self.shape["pods"] * self.shape["nodes"]

    def __repr__(self) -> str:
        return (f"Mesh(pods={self.shape['pods']}, "
                f"nodes={self.shape['nodes']}, "
                f"devices={[str(d) for d in self.node_devices]})")


def default_devices():
    """The devices a mesh is built from when none are named: every CUDA
    device of the host (none without a card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, pods_axis: int = 1) -> Mesh:
    """Mesh over ``devices`` (default: ``default_devices()``): ("pods",
    "nodes"). With pods_axis=1 the whole mesh shards the node axis. Raises
    without a device, as ``batch_solver.resolve_device`` does without a
    card."""
    devices = list(default_devices() if devices is None else devices)
    if not devices:
        raise MeshUnavailable(
            "no CUDA device: a mesh is built over the host's CUDA devices "
            "unless the caller names its devices")
    return Mesh(devices, pods_axis)


def maybe_mesh(mode: str = "auto", pods_axis: int = 1) -> Optional[Mesh]:
    """Resolve a --mesh flag to a Mesh or None. ``auto`` builds the mesh
    exactly when more than one device is attached; ``on`` demands one
    (raises ``MeshUnavailable`` on a host with one device or none);
    ``off`` is None."""
    mode = (mode or "auto").strip().lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"mesh={mode!r}: expected auto|on|off")
    if mode == "off":
        return None
    devices = default_devices()
    n = len(devices)
    if n <= 1:
        if mode == "on":
            raise MeshUnavailable(f"--mesh on requires >1 device (have {n})")
        return None
    return make_mesh(devices, pods_axis=pods_axis)


@functools.lru_cache(maxsize=512)
def _pad_width(n: int, shards: int) -> int:
    """Memoized node-axis pad width per (N, mesh shards)."""
    return (-n) % shards


# (axis, decision-invariant fill) of each plane pad_inputs_for_mesh
# extends (absent = unpadded). The one definition: pad_inputs_for_mesh
# builds from it, shard_memory_report derives padded sizes from it, and
# the mesh executor pads a single re-established plane from it. Pad nodes
# are never feasible (node_extra_ok False, fit_exceeded True), advertise
# nothing, carry no capacity, are zone-unlabeled (-1) and
# affinity-unlabeled (-1), hold no peers and no evictable pods.
PAD_SPEC = {
    "cap": (0, 0), "advertises": (0, False), "fit_used": (0, 0),
    "fit_exceeded": (0, True), "score_used": (0, 0),
    "node_ports": (0, 0), "node_sel": (0, 0), "node_pds": (0, 0),
    "node_extra_ok": (0, False), "score_static": (0, 0),
    "node_aff_vals": (0, -1),
    "group_counts": (1, 0), "zone_idx": (1, -1),
    "evict_cap": (0, 0), "evict_cnt": (0, 0),
}


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_padding_invariant(padded: SolverInputs, n: int) -> None:
    """KTPU_DEBUG gate: padding nodes must be decision-invariant — never
    feasible (so they cannot win any tie-break), never advertising
    resources, never zone-labeled, holding no peers. A violation means a
    new SolverInputs field was added without teaching pad_inputs_for_mesh
    its decision-invariant fill."""
    total = int(padded.cap.shape[0])
    if total == n:
        return
    assert not _host(padded.node_extra_ok)[n:].any(), \
        "mesh padding produced a feasible node (node_extra_ok True)"
    assert _host(padded.fit_exceeded)[n:].all(), \
        "mesh padding produced a node with headroom (fit_exceeded False)"
    assert not _host(padded.advertises)[n:].any(), \
        "mesh padding advertises resources"
    assert not _host(padded.cap)[n:].any(), \
        "mesh padding carries capacity"
    assert (_host(padded.zone_idx)[:, n:] == -1).all(), \
        "mesh padding is zone-labeled (would perturb anti-affinity counts)"
    assert (_host(padded.node_aff_vals)[n:] == -1).all(), \
        "mesh padding carries affinity label values"
    assert not _host(padded.evict_cnt)[n:].any(), \
        "mesh padding holds evictable pods (preemption could target it)"
    assert not _host(padded.group_counts)[:, n:total].any(), \
        "mesh padding holds service peers"


def pad_plane(name: str, x, pad: int):
    """One plane (numpy or torch) padded per PAD_SPEC (identity when
    unpadded or pad == 0). ``group_counts`` gains its pad columns before
    its last, off-list column, which stays last."""
    spec = PAD_SPEC.get(name)
    if spec is None or pad == 0:
        return x
    axis, fill = spec
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = pad
        block = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        if name == "group_counts":
            return torch.cat([x[:, :-1], block, x[:, -1:]], dim=1)
        return torch.cat([x, block], dim=axis)
    x = np.asarray(x)
    if name == "group_counts":
        block = np.full((x.shape[0], pad), fill, x.dtype)
        return np.concatenate([x[:, :-1], block, x[:, -1:]], axis=1)
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def pad_inputs_for_mesh(inp: SolverInputs, mesh: Mesh
                        ) -> Tuple[SolverInputs, int]:
    """Pad the node axis to a multiple of the "nodes" mesh axis with
    nodes that can never be chosen (PAD_SPEC fills). Returns (padded
    inputs, original N). Pad widths are memoized per (N, mesh shards);
    with KTPU_DEBUG set, the padded planes are re-checked for the
    decision-invariance the fills guarantee."""
    shards = mesh.shape["nodes"]
    n = int(inp.cap.shape[0])
    pad = _pad_width(n, shards)
    if pad == 0:
        return inp, n
    padded = SolverInputs(**{name: pad_plane(name, getattr(inp, name), pad)
                             for name in SolverInputs._fields})
    if _DEBUG:
        _assert_padding_invariant(padded, n)
    return padded, n


def input_shardings(mesh: Mesh) -> SolverInputs:
    """Placement per input: the node axis a plane shards over the mesh's
    "nodes" axis (``group_counts``: its node columns, the off-list column
    replicated), or None for a replicated plane — every per-pod plane, the
    zone totals ``zone_counts0`` and the band values ``band_prio``. The
    "pods" axis replicates everything."""
    return SolverInputs(**{f: NODE_AXIS.get(f) for f in SolverInputs._fields})


def as_tensor(a) -> torch.Tensor:
    """A host plane or a tensor -> a tensor (uint32 words as their int32
    bit patterns, as batch_solver.ship_inputs ships them)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int32) if a.dtype == torch.uint32 else a
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _owned(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``dev`` that aliases nothing (a
    tensor from numpy on the CPU shares the array's memory; the executor
    scatters deltas into its planes in place)."""
    out = t.to(dev, copy=True)
    return out if out.is_contiguous() else out.contiguous()


def place_plane(name: str, a, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """One (padded) plane -> one tensor per node shard, on the shard's
    device, each its own copy: a node-sharded plane split into equal
    contiguous slices (``group_counts`` each with the off-list column
    last), a replicated plane copied once per distinct device and shared
    by the shards on it."""
    t = as_tensor(a)
    devs = mesh.node_devices
    axis = NODE_AXIS.get(name)
    if axis is None:
        copies: dict = {}
        for d in devs:
            if d not in copies:
                copies[d] = _owned(t, d)
        return tuple(copies[d] for d in devs)
    S = len(devs)
    if name == "group_counts":
        body, offl = t[:, :-1], t[:, -1:]
        return tuple(_owned(torch.cat([part, offl], dim=1), d)
                     for part, d in zip(torch.tensor_split(body, S, dim=1),
                                        devs))
    return tuple(_owned(part, d)
                 for part, d in zip(torch.tensor_split(t, S, dim=axis), devs))


def place_inputs(inp: SolverInputs, mesh: Mesh, fields):
    """``place_plane`` of each field in ``fields`` -> a tuple of
    per-shard tuples."""
    return tuple(place_plane(f, getattr(inp, f), mesh) for f in fields)


def shard_memory_report(inp: SolverInputs, mesh: Mesh) -> dict:
    """Bytes per device for one wave under the mesh's placement: the
    (padded, as allocated) inputs, the commit loop's copies of the mutable
    planes (the scan carry), and each shard's static feasibility mask (the
    prolog's [P, n] uint8 plane), by shape arithmetic only."""
    shards = mesh.shape["nodes"]
    n = int(inp.cap.shape[0])
    pad = _pad_width(n, shards)

    def nbytes(name: str, per_shard: bool = False) -> int:
        a = getattr(inp, name)
        shape = list(a.shape)
        if name in PAD_SPEC:
            shape[PAD_SPEC[name][0]] += pad
        axis = NODE_AXIS.get(name)
        if per_shard and axis is not None:
            if name == "group_counts":
                shape[1] = (shape[1] - 1) // shards + 1
            else:
                shape[axis] //= shards
        item = (a.element_size() if isinstance(a, torch.Tensor)
                else np.dtype(a.dtype).itemsize)
        return int(np.prod(shape)) * item

    per_device = sum(nbytes(f, True) for f in SolverInputs._fields
                     if f in NODE_AXIS)
    replicated = sum(nbytes(f) for f in SolverInputs._fields
                     if f not in NODE_AXIS)
    carry = sum(nbytes(f, True) for f in (
        "fit_used", "score_used", "node_ports", "node_pds", "group_counts",
        "evict_cap", "evict_cnt")) + sum(nbytes(f) for f in (
            "anchor_vals0", "has_anchor0"))
    static_mask = (int(inp.req.shape[0])
                   * commit_solver.mask_pitch((n + pad) // shards))
    return {
        "devices": mesh.size,
        "node_shards": shards,
        "sharded_bytes_per_device": per_device,
        "replicated_bytes_per_device": replicated,
        "carry_bytes_per_device": carry,
        "static_mask_bytes_per_device": static_mask,
        "total_bytes_per_device": (per_device + replicated + carry
                                   + static_mask),
    }


def sharded_program(mesh: Mesh, pol, gangs: bool):
    """The wave solve over ``mesh``'s node shards: ``fn(resident, wave) ->
    (chosen, scores)``, int32 [P] tensors on the first shard's device,
    with ``resident`` and ``wave`` tuples (RESIDENT_FIELDS / WAVE_FIELDS
    order) of per-shard tuples as ``place_plane`` lays them out. One shard
    is the single-device solve (``batch_solver.solve_device``: the
    commit_solve kernel for a wave inside its domain, else the plain
    ``solve_scan``), more run the sharded loop
    (``sharded_scan.solve_shards``)."""
    from kubernetes_tpu_torch.parallel import sharded_scan

    def run(resident, wave):
        shards = []
        for s in range(mesh.shape["nodes"]):
            kw = {f: planes[s] for f, planes in zip(RESIDENT_FIELDS, resident)}
            kw.update({f: planes[s] for f, planes in zip(WAVE_FIELDS, wave)})
            shards.append(SolverInputs(**kw))
        if len(shards) == 1:
            return solve_device(shards[0], pol, gangs,
                                peer_bound_of(shards[0]))
        return sharded_scan.solve_shards(shards, pol, gangs)

    return run


def _on_device(inp: SolverInputs, dev: torch.device) -> SolverInputs:
    return SolverInputs(*(as_tensor(a).to(dev) for a in inp))


def solve_sharded(inp: SolverInputs, mesh: Optional[Mesh] = None,
                  w_lr: int = 1, w_spread: int = 1, w_equal: int = 0,
                  pol=None, gangs: bool = False,
                  peer_bound: Optional[int] = None,
                  prefer_kernel: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Solve one wave (host numpy or tensor SolverInputs) under a device
    mesh -> host (chosen, scores). Decisions are identical to the
    single-device path; only the layout (and dispatch) changes. Gang
    callers apply gang.apply_all_or_nothing to the returned decisions, as
    with solve.

    Dispatch is a crossover, as in the reference:

    - **a wave inside the kernel's domain** (``commit_solver.eligible``)
      runs on ONE device, the mesh's first, through
      ``batch_solver.solve_device``: one launch of the commit_solve kernel
      on a card (its plain version on the CPU). Sharding the node axis
      would put a cross-shard reduction inside every pod step; the
      kernel's state for a 65,536-node wave lives in one SM's shared
      memory and L2.
    - **a wave beyond it** (more than 65,536 nodes, 1,024 service groups
      or 32 bands, peer totals from 2^24, or wider than 8 resources or 4
      labels) runs the sharded loop over the mesh: the capacity path.

    ``peer_bound`` (batch_solver.peer_bound_of) gates kernel eligibility;
    None computes it from the inputs."""
    from kubernetes_tpu_torch.models.policy import BatchPolicy

    p = pol or BatchPolicy(w_lr=w_lr, w_spread=w_spread, w_equal=w_equal)
    mesh = mesh or make_mesh()
    if prefer_kernel:
        if peer_bound is None:
            peer_bound = peer_bound_of(inp)
        if commit_solver.eligible(inp, p, peer_bound):
            chosen, scores = solve_device(
                _on_device(inp, mesh.node_devices[0]), p, gangs, peer_bound)
            both = torch.stack([chosen, scores]).cpu().numpy()
            return both[0], both[1]
    padded, n = pad_inputs_for_mesh(inp, mesh)
    resident = place_inputs(padded, mesh, RESIDENT_FIELDS)
    wave = place_inputs(padded, mesh, WAVE_FIELDS)
    chosen, scores = sharded_program(mesh, p, gangs)(resident, wave)
    both = torch.stack([chosen, scores]).cpu().numpy()
    chosen, scores = both[0], both[1]
    # padded nodes are infeasible, so indices never point past n
    assert chosen.max(initial=-1) < n
    return chosen, scores
