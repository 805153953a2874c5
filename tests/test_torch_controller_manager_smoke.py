"""chip_smoke.py's phase 15 at a small size, on the plain version.

The port's kube-apiserver and kube-controller-manager as processes, both
with ``--cloud-provider inventory``, and the scheduler binary in a
thread: the NodeController registers 40 inventory nodes and writes their
conditions, north_star's residents and services are seeded, 4 RCs of 50
are created, the inventory loses 4 instances (their nodes and pods go,
the RCs recreate what they lost), then one RC scales down and one up.
The phase checks every RC at its count and bound, no replica created
beyond the counts, nothing on a departed node, each wave against the plain version and solve(encode_snapshot(...))
of the encoder's state; here each wave's bindings are also held against
the JAX package's ``batch_solver.solve`` of the same state, its objects
carried over the v1 wire. At 40 nodes the host-port templates are left
out: 50 replicas of one host port cannot fit on 40 nodes. Launches are
not counted (the plain version runs instead of the kernel).
"""

import json

import chip_smoke
from kubernetes_tpu.api.latest import scheme as ref_scheme
from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu_torch.api.latest import scheme as port_scheme


def _to_ref(objs):
    """Port API objects as the reference's, through the v1 wire."""
    return [ref_scheme.decode(json.dumps(port_scheme.encode_to_wire(o)))
            for o in objs]


def test_controller_phase_feeds_the_scheduler():
    c = chip_smoke._controller_phase(
        "cpu", n_nodes=40, apps=2, versions=2, replicas=50, n_gone=4,
        scale=(("rc-0-1", 20), ("rc-1-1", 80)), host_ports=False,
        seeders=4, wave_size=32, wave_period=0.2, count_launches=False,
        keep_rows=True)
    steps = c["steps"]
    assert steps["load"]["pods"] == 200
    assert steps["shrink"]["nodes_gone"] == 4
    assert steps["shrink"]["rc_pods_lost"] > 0
    assert steps["shrink"]["created"] >= steps["shrink"]["rc_pods_lost"]
    assert steps["scale"]["taken_from"] == ["rc-0-1"]
    assert c["over_created"] == 0
    assert c["encodes"]["full"] >= 2   # the first wave and the node deletes
    assert c["encodes"]["delta"] > 0
    rows, svcs = c["rows"], _to_ref(c["svcs"])
    assert len(rows) == len(c["waves"]) > 3
    for k, r in enumerate(rows):
        snap = ref_encode(_to_ref(r["nodes"]), _to_ref(r["existing"]),
                          _to_ref(r["order"]), svcs)
        chosen, _ = ref_bs.solve(snap)
        want = [(p.metadata.name, h) for p, h in
                zip(r["order"], ref_bs.decisions_to_names(snap, chosen)) if h]
        assert sorted(want) == sorted(r["placed"]), f"wave {k}"
