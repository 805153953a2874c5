"""chip_smoke.py's phase 18 (a) at a small size, on the plain version.

The port's kube-apiserver and kube-controller-manager (``--cloud-provider
inventory``) as hyperkube processes over 40 of north_star's instances,
each at a loopback address of its own; two of them run a kubelet
process (process runtime) and are labelled ``role=serving`` by kubectl
processes; kube-proxy, the dns, monitoring and logging addons as
processes; the scheduler binary in a thread. Eight RCs of one
hostnames backend each (host network, their own ports) behind the
service ``hostnames``: a soak through the proxy reaches every backend
with no error, two rounds of two deletes churn them, a second soak is
clean again; the dns process resolves every service and answers
NXDOMAIN for a deleted one, the logging process returns every start
line, the monitoring process scrapes the two kubelets. Each of the
binary's waves is held against the plain version and
solve(encode_snapshot(...)) of its state by the phase, and here also
against the JAX package's ``batch_solver.solve`` of the same state, its
objects carried over the v1 wire. Launches are not counted (the plain
version runs instead of the kernel).
"""

import chip_smoke
from test_torch_descheduler_smoke import _held_against_the_reference


def test_service_path_through_the_proxy():
    a = chip_smoke._service_phase(
        "cpu", n_nodes=40, kubelets=2, backends=8, churn=(2, 2, 2.0),
        soak_s=2.0, wave_size=32, count_launches=False, keep_rows=True)
    assert a["per_node"] == {"node-00000": 4, "node-00001": 4}
    assert a["steady"]["errors"] == 0 and a["steady"]["names"] == 8
    assert a["settled"]["errors"] == 0 and a["settled"]["names"] == 8
    assert a["churn"]["deleted"] == 4
    assert a["dns"]["queries"] == 90
    assert a["monitoring"] == {"nodes": 40,
                               "up": ["node-00000", "node-00001"]}
    assert a["logging"]["collect_pass_lines"] >= 8
    assert len(a["rows"]) == len(a["waves"]) >= 2
    assert sum(len(r["bound_names"]) for r in a["rows"]) == 12
    _held_against_the_reference(a["rows"], a["svcs"])
