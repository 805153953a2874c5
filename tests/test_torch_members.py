"""Members of ported modules that a reference caller or test uses, each
held against the JAX package's on the same inputs: ``Gauge.dec`` and
``Histogram.quantile`` (util/metrics.py), ``Backoff.attempt`` and
``Backoff.sleep_next`` (util/retry.py), ``ClusterSnapshot.n_nodes`` and
``n_pods`` (models/snapshot.py) and ``snapshot_to_inputs``
(models/batch_solver.py). Inputs are drawn with numpy from a seed; every
comparison is exact."""

import random

import numpy as np
import pytest

from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.util import metrics as ref_metrics
from kubernetes_tpu.util import retry as ref_retry
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.util import metrics
from kubernetes_tpu_torch.util import retry
from test_torch_batch_solver import PORT, REF, WAVES

SEED = 20261017


def test_gauge_dec_matches_reference():
    rng = np.random.default_rng(SEED)
    gauges = [m.Gauge("g_depth", "depth", ("shard",))
              for m in (metrics, ref_metrics)]
    for _ in range(200):
        shard, by = str(rng.integers(3)), float(rng.integers(1, 5))
        op = rng.integers(3)
        for g in gauges:
            if op == 0:
                g.inc(shard, by=by)
            elif op == 1:
                g.dec(shard, by=by)
            else:
                g.dec(shard)
    assert gauges[0].by_label() == dict(gauges[1]._values)
    assert gauges[0].render() == gauges[1].render()


@pytest.mark.parametrize("n_obs", [0, 1, 7, 500])
def test_histogram_quantile_matches_reference(n_obs):
    rng = np.random.default_rng(SEED + n_obs)
    buckets = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0)
    hists = [m.Histogram("h_seconds", "h", ("op",), buckets=buckets)
             for m in (metrics, ref_metrics)]
    # a log-uniform spread that also overflows the top bucket
    for v in 10 ** rng.uniform(-3, 1.2, n_obs):
        op = "a" if rng.random() < 0.7 else "b"
        for h in hists:
            h.observe(float(v), op)
    for q in (0.0, 1e-9, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        for op in ("a", "b", "missing"):
            assert hists[0].quantile(q, op) == hists[1].quantile(q, op), \
                (q, op)


def test_backoff_attempt_and_sleep_next_match_reference():
    slept = ([], [])
    offs = [pkg.Backoff(base=0.05, cap=1.0, rng=random.Random(SEED),
                        sleep=out.append)
            for pkg, out in zip((retry, ref_retry), slept)]
    for k in range(7):
        assert offs[0].attempt == offs[1].attempt == k
        assert offs[0].sleep_next() == offs[1].sleep_next()
    for b in offs:
        b.reset()
    assert offs[0].attempt == offs[1].attempt == 0
    assert slept[0] == slept[1] and len(slept[0]) == 7
    assert max(slept[0]) <= 1.0 * 1.25


@pytest.mark.parametrize("name", list(WAVES))
def test_snapshot_sizes_and_inputs_match_reference(name):
    port = encode_snapshot(*WAVES[name](PORT))
    ref = ref_encode(*WAVES[name](REF))
    assert (port.n_nodes, port.n_pods) == (ref.n_nodes, ref.n_pods)
    assert port.n_nodes == len(port.node_names) > 0
    got = bs.snapshot_to_inputs(port, device="cpu")
    want = ref_bs.snapshot_to_inputs(ref)
    assert got._fields == want._fields
    for f, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        a = a.numpy()
        if b.dtype == np.uint32:    # shipped as the int32 bit pattern
            a = a.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
