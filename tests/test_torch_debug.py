"""The port's ``KTPU_DEBUG=1`` self-checks, each seen firing on corrupted
state and staying silent without the flag.

The flag is read when each module is imported, so every case runs a
small script in a child interpreter with ``KTPU_DEBUG`` set or unset:

- the resident zone-count recompute (``models/batch_solver.py``): the
  incremental encoder's ``zone_counts0`` planes against
  ``derive_zone_counts`` of the wave's own planes;
- the evictable-plane recompute (``models/incremental.py``): the
  O(bands) resident evictable planes against
  ``preempt.derive_evict_planes`` of the encoder's pod records;
- the journal-replay gate (``scheduler/tpu_batch.py``): after a replay
  resync, a full diff-walk over the authoritative pod list must leave the
  encoder's resident fingerprint unchanged.

Each script prints ``FIRED <message>`` when a check raised, ``QUIET``
otherwise.
"""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = '''
import sys
import numpy as np
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.models.policy import BatchPolicy


def node(i, zone=None):
    labels = {"zone": zone} if zone else {}
    return api.Node(metadata=api.ObjectMeta(name=f"n{i}", labels=labels),
                    spec=api.NodeSpec(capacity={"cpu": Quantity("1"),
                                                "memory": Quantity("8Gi")}))


def pod(name, host="", prio=0, labels=None, mcpu=400):
    return api.Pod(
        metadata=api.ObjectMeta(name=name, namespace="default",
                                uid="uid-" + name, labels=labels or {}),
        spec=api.PodSpec(priority=prio, containers=[api.Container(
            name="c", image="i", resources=api.ResourceRequirements(
                limits={"cpu": Quantity(f"{mcpu}m"),
                        "memory": Quantity("64Mi")}))]),
        status=api.PodStatus(host=host))


def run(check):
    try:
        check()
    except AssertionError as e:
        print("FIRED", str(e).replace("\\n", " "))
        return
    print("QUIET")
'''

ZONES = '''
from kubernetes_tpu_torch.models.batch_solver import snapshot_to_host_inputs

def check():
    pol = BatchPolicy(anti_affinity=(("zone", 2),))
    nodes = [node(i, f"z{i % 3}") for i in range(6)]
    svc = api.Service(metadata=api.ObjectMeta(name="s", namespace="default"),
                      spec=api.ServiceSpec(port=80, selector={"app": "x"}))
    existing = [pod(f"e{i}", host=f"n{i}", labels={"app": "x"})
                for i in range(4)]
    enc = IncrementalEncoder(pol)
    snap = enc.encode(nodes, existing, [pod("p", labels={"app": "x"})], [svc])
    snapshot_to_host_inputs(snap)          # consistent: never fires
    snap.zone_counts0[0, 0, 1] += 1        # corrupt the resident plane
    snapshot_to_host_inputs(snap)

run(check)
'''

EVICT = '''
def check():
    nodes = [node(i) for i in range(3)]
    existing = [pod(f"low{i}", host=f"n{i}", prio=10) for i in range(3)]
    enc = IncrementalEncoder(BatchPolicy())
    enc.encode(nodes, existing, [pod("high", prio=1000)])   # consistent
    enc._evict_cap[1, 0, 0] += 7           # corrupt the resident plane
    enc.encode_delta(nodes, [], [], [pod("high2", prio=1000)])

run(check)
'''

REPLAY = '''
import types
from kubernetes_tpu_torch.scheduler.tpu_batch import BatchScheduler
from kubernetes_tpu_torch.util import metrics

def check():
    nodes = [node(i) for i in range(3)]
    existing = [pod(f"e{i}", host=f"n{i}") for i in range(3)]
    enc = IncrementalEncoder(BatchPolicy())
    enc.encode(nodes, existing, [pod("p0")])
    # the journal says e0 moved to n2; the authoritative list disagrees
    moved = pod("e0", host="n2")
    sched = types.SimpleNamespace(
        _ckpt=(enc.checkpoint(), 0), _encoder=enc, _delta_token=0,
        config=types.SimpleNamespace(modeler=types.SimpleNamespace(
            delta=lambda token: ([moved], [], 1))),
        _sx=types.SimpleNamespace(resync_replay=metrics.Counter("r", "r")),
        _maybe_checkpoint=lambda token: None)
    sched._debug_verify_replay = types.MethodType(
        BatchScheduler._debug_verify_replay, sched)
    snap, reason = BatchScheduler._replay_resync(
        sched, nodes, [pod("p1")], [], lambda: existing)
    assert snap is not None and reason == "", reason   # the replay ran

run(check)
'''


def _run(script: str, debug: bool) -> str:
    env = {k: v for k, v in os.environ.items() if k != "KTPU_DEBUG"}
    if debug:
        env["KTPU_DEBUG"] = "1"
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(PRELUDE + script)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("script,message", [
    (ZONES, "resident zone_counts0 diverged"),
    (EVICT, "resident evictable planes diverged"),
    (REPLAY, "journal replay diverged"),
], ids=["zone-counts", "evictable-planes", "journal-replay"])
def test_debug_check_fires_on_corrupted_state(script, message):
    out = _run(script, debug=True)
    assert out.startswith("FIRED") and message in out, out


@pytest.mark.parametrize("script", [ZONES, EVICT, REPLAY],
                         ids=["zone-counts", "evictable-planes",
                              "journal-replay"])
def test_no_check_runs_without_the_flag(script):
    assert _run(script, debug=False) == "QUIET"
