"""The cluster instances' arithmetic on the CPU.

A large wave runs on a thread-block cluster of C blocks
(csrc/commit_solve_cluster.cuh): block b owns the nodes [b S, b S + S),
thread t of a block its local nodes t + 1024 i, and the k-th best node in
node order is found in three layers (the blocks' counts, the row-major
(row, warp) cells, the lanes of a warp's ballot). ``commit_solver`` keeps a
plain mirror of that ownership map and rank (``slice_nodes``,
``cluster_ranks``, ``cluster_pick``) and of the layout the wrapper picks
(``cluster_for``); these tests hold the mirrors to node order and to the
shared memory a block has. The kernel itself runs only on a card
(chip_smoke.py phase 20 holds it against the plain version there).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import fixtures
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.ops import commit_solver as cs

NODES = [1, 16, 1_023, 1_024, 1_025, 32_641, 40_000, 65_536]
SIZES = [2, 4, 8, 16]
ROOM = cs.SMEM_PER_BLOCK - cs.CLUSTER_STATIC_SMEM


def _best(N, C, seed=0):
    """A seeded best mask over N nodes: a density of its own per case,
    from all but empty to all but full."""
    rng = np.random.default_rng(N * 31 + C + seed)
    return rng.random(N) < rng.choice([0.001, 0.05, 0.5, 0.97])


@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("N", NODES)
def test_slices_cover_the_nodes_once(N, C):
    S = cs.slice_nodes(N, C)
    assert S % 16 == 0 and S >= -(-N // C) and S - -(-N // C) < 16
    assert S <= cs.THREADS * cs.MAX_ROWS
    covered = np.zeros(N, dtype=np.int64)
    for b in range(C):
        lo = b * S
        assert lo % 16 == 0
        covered[lo:min(lo + S, N)] += 1
    assert (covered == 1).all()
    # the ownership map: (block, thread, row) of each node is its own
    n = np.arange(N)
    b, j = n // S, n % S
    owner = (b * cs.THREADS + j % cs.THREADS) * cs.MAX_ROWS + j // cs.THREADS
    assert (b < C).all() and (j // cs.THREADS < cs.MAX_ROWS).all()
    assert len(np.unique(owner)) == N


@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("N", NODES)
def test_three_layer_rank_is_node_order(N, C):
    best = _best(N, C)
    nodes = np.flatnonzero(best)
    total = len(nodes)
    ranks = cs.cluster_ranks(best, C)
    # every best node's rank is its place among the best nodes in node
    # order; the others have none
    assert (ranks[nodes] == np.arange(total)).all()
    assert (ranks[~best] == -1).all()
    # the k-th node the kernel's search takes is the k-th set bit
    rng = np.random.default_rng(N + C)
    ks = (range(total) if total <= 600
          else sorted({0, 1, total - 2, total - 1,
                       *rng.integers(0, total, 200).tolist()}))
    for k in ks:
        assert cs.cluster_pick(best, C, k) == nodes[k], k


def test_rank_of_an_empty_and_a_full_mask():
    for N, C in ((40_000, 16), (1_025, 2)):
        assert (cs.cluster_ranks(np.zeros(N, bool), C) == -1).all()
        full = np.ones(N, bool)
        assert (cs.cluster_ranks(full, C) == np.arange(N)).all()
        assert cs.cluster_pick(full, C, N - 1) == N - 1


def _widths(name, count_bytes):
    """(N, R, Wp, Wd, G, B, res_bytes, count_bytes) of a full shape, its
    widths read from a 64-node build of the same fixture."""
    n_nodes, _n_pods, kw, _policy = fixtures.FULL_SHAPES[name]
    snap = encode_snapshot(*fixtures.build_cluster(64, 100, **kw))
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
    ci = cs.prepare(inp, snap.policy, snap.has_gangs)
    return (n_nodes, ci.cap.shape[0], ci.ports0.shape[0], ci.pds0.shape[0],
            ci.counts0.shape[0], ci.band.shape[0], ci.cap.element_size(),
            count_bytes)


@pytest.mark.parametrize("name,count_bytes,want_s", [
    ("planet", 4, 2_512),       # 40,000 peers a service: int32 counts
    ("services64", 2, 320),     # 64 groups of int16 counts
])
def test_planet_and_services64_keep_their_slices_on_chip(name, count_bytes,
                                                         want_s):
    N, R, Wp, Wd, G, B, res_bytes, cnt = _widths(name, count_bytes)
    assert cs.is_large(N, G, cnt)
    # the most blocks the card schedules, the slices on chip
    C, on_chip, nbytes = cs.cluster_for(N, R, Wp, Wd, G, B, res_bytes, cnt)
    assert (C, on_chip) == (16, True)
    S = cs.slice_nodes(N, C)
    assert S == want_s
    assert nbytes == 2 * S + cs.slice_bytes(S, R, Wp, Wd, G, B, res_bytes,
                                            cnt)
    assert nbytes <= ROOM
    # a card that schedules fewer blocks gets as many, the slices larger
    C, on_chip, nbytes = cs.cluster_for(N, R, Wp, Wd, G, B, res_bytes, cnt,
                                        max_cluster=8)
    assert C == 8 and nbytes <= ROOM
    assert on_chip == (cs.cluster_bytes(N, 8, R, Wp, Wd, G, 0, B, res_bytes,
                                        cnt) <= ROOM)


def test_the_widest_slices_stay_in_global_memory():
    # 65,536 nodes x 1,024 groups of int32 counts: 16 MB a block at C = 16
    C, on_chip, nbytes = cs.cluster_for(cs.MAX_N, 2, 1, 1, cs.MAX_G, 0, 4,
                                        4)
    assert (C, on_chip) == (16, False)
    assert nbytes == 2 * cs.slice_nodes(cs.MAX_N, 16) == 8_192
    # the card's limit caps C, and the layout follows
    assert cs.cluster_for(cs.MAX_N, 2, 1, 1, cs.MAX_G, 0, 4, 4,
                          max_cluster=8) == (8, False, 16_384)


@pytest.mark.parametrize("res_bytes,cnt,G,L,B", [
    (4, 2, 0, 0, 0), (4, 4, 8, 0, 0), (4, 2, 64, 2, 0), (8, 4, 40, 4, 3),
    (4, 4, 1_024, 4, 32), (8, 2, 1_024, 1, 8),
])
def test_every_block_fits_its_shared_memory(res_bytes, cnt, G, L, B):
    for N in NODES:
        for cluster in (None, *SIZES):
            C, on_chip, nbytes = cs.cluster_for(N, 3, 2, 1, G, B, res_bytes,
                                                cnt, L, cluster=cluster)
            assert nbytes <= ROOM, (N, cluster)
            assert nbytes == cs.cluster_bytes(N, C, 3, 2, 1, G, L, B,
                                              res_bytes, cnt, on_chip)
            if cluster is not None:
                assert C == cluster
                # the layout is on chip exactly when the slices fit
                assert on_chip == (cs.cluster_bytes(
                    N, C, 3, 2, 1, G, L, B, res_bytes, cnt) <= ROOM)


def test_cluster_sizes_outside_the_kernel_are_refused():
    with pytest.raises(ValueError):
        cs.cluster_for(1_000, 2, 1, 1, 8, cluster=3)
    with pytest.raises(ValueError):
        cs.cluster_for(1_000, 2, 1, 1, 8, cluster=32)
    with pytest.raises(RuntimeError):
        cs.cluster_for(1_000, 2, 1, 1, 8, max_cluster=1)


def _ci(n_nodes, n_services, count_bytes=None):
    snap = encode_snapshot(*fixtures.build_cluster(n_nodes, 60,
                                                   n_services=n_services))
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
    ci = cs.prepare(inp, snap.policy, snap.has_gangs)
    return ci._replace(count_bytes=count_bytes) if count_bytes else ci


@pytest.mark.parametrize("res", ["i", "x"])
def test_instance_names_match_the_ptxas_report(res):
    # ptxas names commit_solve_cluster_kernel<Res, Cnt, kShared> by its
    # mangled template arguments; chip_smoke reads them back into the
    # names instance_of gives, less the cluster's size
    log = "\n".join(
        f"ptxas info    : Compiling entry function "
        f"'_ZN4kgpu27commit_solve_cluster_kernelI{res}{cnt}Lb{sh}EEEvPKh'\n"
        f"ptxas info    : Used 64 registers, used 1 barriers"
        for cnt in "si" for sh in "01")
    report = chip_smoke._ptxas_report(log)
    resname = "int32" if res == "i" else "int64"
    assert sorted(report) == sorted(
        f"commit_solve_large<{resname},counts{c},{lay}>"
        for c in (16, 32) for lay in ("shared", "global"))
    ci = _ci(40, 64)
    if res == "x":
        ci = ci._replace(**{f: getattr(ci, f).to(torch.int64) for f in
                            ("cap", "fit0", "score0", "off", "ecap0",
                             "req")})
    for cluster in SIZES:
        name = cs.instance_of(ci, cluster=cluster)
        assert name.endswith(f",c{cluster}>")
        assert chip_smoke._ptxas_of(report, name) == \
            "Used 64 registers, used 1 barriers; "


def test_layout_and_instance_of_a_large_wave_follow_cluster_for():
    ci = _ci(300, 64)
    dims = (300, ci.cap.shape[0], ci.ports0.shape[0], ci.pds0.shape[0], 64,
            0, 4, 2)
    C, on_chip, nbytes = cs.cluster_for(*dims)
    assert cs.layout_of(ci) == (on_chip, nbytes)
    assert cs.instance_of(ci) == \
        f"commit_solve_large<int32,counts16,shared,c{C}>"
    # a wave of the one-block domain takes the cluster instances when given
    # a cluster, and its one-block instance otherwise
    small = _ci(300, 8)
    assert cs.instance_of(small).startswith("commit_solve<int32,")
    assert cs.layout_of(small) == cs.shared_layout(
        300, small.cap.shape[0], small.ports0.shape[0],
        small.pds0.shape[0], 8)
    assert cs.instance_of(small, cluster=8) == \
        "commit_solve_large<int32,counts16,shared,c8>"
    assert cs.layout_of(small, 8) == cs.cluster_for(
        300, small.cap.shape[0], small.ports0.shape[0], small.pds0.shape[0],
        8, cluster=8)[1:]


def test_a_cpu_wave_given_a_cluster_runs_the_plain_version():
    ci = _ci(300, 64)
    launches = cs.solve_commit.launches
    calls = cs.solve_commit_reference.calls
    got = cs.solve_commit(ci, _cluster=4)
    assert cs.solve_commit.launches == launches
    assert cs.solve_commit_reference.calls == calls + 1
    want = cs.solve_commit_reference(ci)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_static_shared_memory_check_holds_the_reserve():
    # chip_smoke phase 2 refuses an instance whose static shared memory
    # (ptxas' report) passes the room the wrapper keeps beside a block's
    # dynamic shared memory
    def report(nbytes):
        return {"commit_solve_large<int32,counts16,shared>":
                f"Used 64 registers, used 1 barriers, {nbytes} bytes smem; ",
                "commit_solve<int32,0,0,0,0,0,1,0>":
                "Used 64 registers, used 1 barriers, 1040 bytes smem; "}
    chip_smoke._static_smem_within_reserve(report(9_744))
    with pytest.raises(AssertionError, match="static shared memory"):
        chip_smoke._static_smem_within_reserve(
            report(cs.CLUSTER_STATIC_SMEM + 1))
