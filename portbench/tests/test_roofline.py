"""The roofline's copy against chip_smoke._bound, on seeded small waves:
the same least time from the benchmark's own shapes and the reference's
count of feasible pairs as from the port's prepared planes and its plain
version's count."""

import sys

import pytest

from portbench import manifest
from portbench.reference import scheduler as reference
from portbench.tests._small import NAMES, waves

_roofline = manifest.module("metrics", "_roofline")


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(manifest.ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("seed", [3, 2**31 + 3])
@pytest.mark.parametrize("name", NAMES)
def test_bound_equals_chip_smokes(chip_smoke, name, seed):
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver

    base, bursts = waves(name, seed)
    for burst in bursts:
        snap = encode_snapshot(base.nodes, base.residents, burst.pods,
                               base.services)
        ci = chip_smoke._inputs(snap, "cpu")
        stats = {}
        commit_solver.solve_commit_reference(ci, stats)
        _, feasible = reference.solve(base.plain, burst.plain)
        assert feasible == int(stats["feasible"].sum())
        d = _roofline.dims(base.plain, burst.plain)
        assert _roofline.bound(d, feasible) == chip_smoke._bound(ci, feasible)
        assert d.res_bytes == ci.cap.element_size()


def test_int64_planes_are_counted_at_eight_bytes():
    base, bursts = waves("north_star.burst", 4, n=1)
    plain = bursts[0].plain
    wide = plain._replace(mem=plain.mem + 10**6)    # decimal megabytes
    assert _roofline.dims(base.plain, plain).res_bytes == 4
    assert _roofline.dims(base.plain, wide).res_bytes == 8
