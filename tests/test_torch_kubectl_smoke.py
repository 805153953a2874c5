"""chip_smoke.py's phase 16 at a small size, on the plain version.

The port's kube-apiserver and kube-controller-manager as processes, the
scheduler binary in a thread, and the port's kubectl as processes over a
kubeconfig in a temporary directory: 40 nodes as a v1beta1 MinionList
and north_star's services as a v1beta2 List through ``kubectl create
-f``, 200 pending pods as a v1beta1 PodList under a v1beta1 watch, 5
nodes cordoned, an RC of 60 run and resized to 120, a rolling update of
4 replicas, a pod that fits nowhere described, and the tear-down. The
phase checks every bind in both wire versions, no RC pod on a cordoned
node, and each wave against the plain version and
solve(encode_snapshot(...)) of the encoder's state; here each wave's
bindings are also held against the JAX package's ``batch_solver.solve``
of the same state, its objects carried over the v1 wire. Launches are
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


def test_kubectl_phase_feeds_the_scheduler():
    k = chip_smoke._kubectl_phase(
        "cpu", n_nodes=40, n_legacy=200, web=(60, 120), n_cordon=5,
        small=4, seeders=4, wave_size=32, wave_period=0.2,
        count_launches=False, keep_rows=True)
    steps = k["steps"]
    assert steps["legacy"]["pods"] == 200
    assert steps["web"]["created"] >= 120
    assert steps["teardown"]["pods_left"] == k["existing"] == 80
    assert k["breakdown"]["N"] in (35, 36)
    assert "FailedScheduling" in k["describe"]
    assert k["kubectl_runs"] > 20
    assert k["encodes"]["full"] >= 2   # the first wave and the cordons
    rows, svcs = k["rows"], _to_ref(k["svcs"])
    assert len(rows) == len(k["waves"]) > 5
    for n, r in enumerate(rows):
        snap = ref_encode(_to_ref(r["nodes"]), _to_ref(r["existing"]),
                          _to_ref(r["order"]), svcs)
        chosen, _ = ref_bs.solve(snap)
        want = [(p.metadata.name, h) for p, h in
                zip(r["order"], ref_bs.decisions_to_names(snap, chosen)) if h]
        assert sorted(want) == sorted(r["placed"]), f"wave {n}"
