"""The port's ops/kernels against the JAX package's ops/kernels and the
serial float32 reference.

Every comparison is exact (integer outputs, tolerance 0); inputs come from
numpy generators with fixed seeds and go to both packages as numpy arrays.
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as ref
from kubernetes_tpu.scheduler.priorities import spread_score_f32
from kubernetes_tpu_torch.ops import kernels

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)


def _port_spread(totals, counts):
    return kernels.spread_score(torch.from_numpy(totals),
                                torch.from_numpy(counts)).numpy()


def _ref_spread(totals, counts):
    return np.asarray(ref.spread_score(jnp.asarray(totals),
                                       jnp.asarray(counts)))


def _f32_spread(totals, counts):
    return np.array([spread_score_f32(int(t), int(c)) if t > 0 else 10
                     for t, c in zip(totals, counts)], np.int32)


def test_spread_154_of_154_is_ten():
    # float32 division by reciprocal multiply gives 0.99999994 here
    t = np.array([154], np.int64)
    c = np.array([0], np.int64)
    assert _port_spread(t, c).tolist() == [10]
    assert _ref_spread(t, c).tolist() == [10]
    assert spread_score_f32(154, 0) == 10


def test_spread_every_pair_below_1024():
    totals = np.repeat(np.arange(1024, dtype=np.int64),
                       np.arange(1, 1025))
    starts = np.repeat(np.cumsum(np.arange(1, 1025)) - np.arange(1, 1025),
                       np.arange(1, 1025))
    counts = np.arange(totals.size, dtype=np.int64) - starts
    assert (counts >= 0).all() and (counts <= totals).all()
    got = _port_spread(totals, counts)
    assert got.dtype == np.int32
    assert np.array_equal(got, _ref_spread(totals, counts))
    assert np.array_equal(got, _f32_spread(totals, counts))


def test_spread_random_totals_below_2_24():
    rng = np.random.RandomState(11)
    totals = rng.randint(1, 1 << 24, 20_000).astype(np.int64)
    counts = (totals * rng.uniform(0, 1, totals.size)).astype(np.int64)
    counts = np.minimum(counts, totals)
    # both ends of the range: no peers, every peer on this node
    counts[:100] = 0
    counts[100:200] = totals[100:200]
    got = _port_spread(totals, counts)
    assert np.array_equal(got, _ref_spread(totals, counts))
    assert np.array_equal(got, _f32_spread(totals, counts))


def test_spread_scalar_total_broadcasts():
    counts = np.arange(0, 38, dtype=np.int64)
    got = kernels.spread_score(torch.tensor(37), torch.from_numpy(counts))
    assert np.array_equal(got.numpy(), _ref_spread(
        np.full(38, 37, np.int64), counts))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_calculate_score_matches_reference(dtype):
    rng = np.random.RandomState(5)
    cap = rng.randint(0, 5000, 4000).astype(dtype)
    cap[:50] = 0
    req = rng.randint(0, 6000, 4000).astype(dtype)
    got = kernels.calculate_score(torch.from_numpy(req), torch.from_numpy(cap))
    want = np.asarray(ref.calculate_score(jnp.asarray(req), jnp.asarray(cap)))
    assert np.array_equal(got.numpy(), want)


def test_u64_mod_small_matches_reference_and_python():
    rng = np.random.RandomState(9)
    hi = rng.randint(0, 1 << 32, 3000, dtype=np.int64)
    lo = rng.randint(0, 1 << 32, 3000, dtype=np.int64)
    m = rng.randint(1, 1 << 31, 3000, dtype=np.int64)
    m[:10] = 1
    got = np.array([int(kernels.u64_mod_small(torch.tensor(h), torch.tensor(lo_),
                                              torch.tensor(mm)))
                    for h, lo_, mm in zip(hi[:300], lo[:300], m[:300])])
    want_py = np.array([((int(h) << 32) | int(lo_)) % int(mm)
                        for h, lo_, mm in zip(hi[:300], lo[:300], m[:300])])
    assert np.array_equal(got, want_py)
    vec = kernels.u64_mod_small(torch.from_numpy(hi), torch.from_numpy(lo),
                                torch.from_numpy(m)).numpy()
    ref_vec = np.asarray(ref.u64_mod_small(jnp.asarray(hi), jnp.asarray(lo),
                                           jnp.asarray(m)))
    assert np.array_equal(vec, ref_vec)


@pytest.mark.parametrize("seed", range(4))
def test_top_count_and_kth_select_match_reference(seed):
    rng = np.random.RandomState(seed)
    scores = rng.randint(-1, 4, 257).astype(np.int32)
    top, any_v, best, cnt = kernels.masked_top_count(
        torch.from_numpy(scores), -1)
    rtop, rany, rbest, rcnt = ref.masked_top_count(jnp.asarray(scores), -1)
    assert int(top) == int(rtop) and bool(any_v) == bool(rany)
    assert np.array_equal(best.numpy(), np.asarray(rbest))
    assert int(cnt) == int(rcnt)
    for k in range(int(cnt)):
        got = kernels.select_kth_true(best, torch.tensor(k))
        want = ref.select_kth_true(rbest, jnp.asarray(k))
        assert int(got) == int(want) == int(np.nonzero(scores == top.item())[0][k])


def test_all_masked_row_reports_nothing_valid():
    scores = np.full(9, -1, np.int32)
    top, any_v, _, cnt = kernels.masked_top_count(torch.from_numpy(scores), -1)
    assert int(top) == -1 and not bool(any_v) and int(cnt) == 9
