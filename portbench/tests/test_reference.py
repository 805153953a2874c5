"""The plain reference against the port's CPU path and its serial
scheduler, on small seeded waves of the cell's mix and of PodGroups."""

import numpy as np
import pytest

from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models.oracle import solve_serial
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.scheduler.generic import fnv1a64
from kubernetes_tpu_torch.scheduler.priorities import spread_score_f32
from portbench.reference import scheduler as reference
from portbench.tests._small import NAMES, waves

SEEDS = (1, 2**31 + 11, 4_000_000_007)


def _port(base, burst):
    snap = encode_snapshot(base.nodes, base.residents, burst.pods,
                           base.services)
    chosen, _ = bs.solve(snap, device="cpu")
    return np.asarray(chosen, np.int64)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", NAMES)
def test_reference_equals_the_ports_cpu_path(name, seed):
    base, bursts = waves(name, seed)
    for burst in bursts:
        want, feasible = reference.solve(base.plain, burst.plain)
        assert np.array_equal(_port(base, burst), want)
        assert feasible > 0
        if name == "gang":
            # the cluster fills: groups place whole or roll back
            g = burst.plain.group
            placed = np.bincount(g[want >= 0], minlength=g.max() + 1)
            assert set(placed.tolist()) == {0, 8}
        else:
            assert (want >= 0).all()


@pytest.mark.parametrize("name", NAMES)
def test_reference_equals_the_serial_scheduler(name):
    base, bursts = waves(name, 3, n=1)
    burst = bursts[0]
    pods = burst.pods[:96]
    plain = burst.plain._replace(
        keys=burst.plain.keys[:96], cpu=burst.plain.cpu[:96],
        mem=burst.plain.mem[:96], port=burst.plain.port[:96],
        service=burst.plain.service[:96], group=burst.plain.group[:96])
    names = solve_serial(base.nodes, base.residents, pods, base.services,
                         gangs=name == "gang")
    want, _ = reference.solve(base.plain, plain)
    assert [base.node_index[n] if n else -1 for n in names] == want.tolist()


def test_fnv_and_spread_match_the_serial_scheduler():
    for key in ("", "a", "uid-1", "4000000007-w3-g0012-m7"):
        assert reference.fnv1a64(key) == fnv1a64(key)
    for top in range(1, 130):
        table = reference.spread_table(top)
        assert table.tolist() == [spread_score_f32(top, c)
                                  for c in range(top + 1)]


def test_bfloat16_spread_differs_somewhere():
    # the reference's bfloat16 spread (for a later cell whose pods have
    # services) differs from float32 only where one node holds 29 peers
    # of a service or more: below that it gives every score float32 gives
    differ = [t for t in range(1, 64)
              if not np.array_equal(reference.spread_table(t),
                                    reference.spread_table(t, "bfloat16"))]
    assert differ and differ[0] == 29
