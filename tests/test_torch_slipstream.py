"""tests/test_slipstream.py against the port: the incremental encoder's
checkpoint and journal replay, the scheduler's resync state machine, the
reflector's watch resume and the slipstream SLO rules.

Left out: the five prewarm cases, which run by hand against the port's
daemon in test_torch_solverd.py (its prewarm section: the reference's
``warm_compile`` is a JAX compile the port has no counterpart of, and
its controller cases are copied there). Their import of ``warm_compile``
is dropped with them.

Below the twin, the resync path with what the loop may lack: a modeler
with no changelog, and a ``get_existing`` that records no pre-token,
each held against the JAX package's ``_encode_incremental`` wave by
wave."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_twin import port_on_the_cpu, port_twin

PREWARM = ("the prewarm cases run against the port's daemon in "
           "test_torch_solverd.py (its prewarm section)")

globals().update(port_twin("test_slipstream", {
    "test_pow2_ladder": PREWARM,
    "test_prewarm_fill_trigger_queues_next_bucket": PREWARM,
    "test_prewarm_boot_set_ready_gate": PREWARM,
    "test_prewarm_compile_failure_is_contained": PREWARM,
    "test_prewarm_swap_under_load": PREWARM,
}, rename={"    warm_compile,\n": ""}))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)


# -- the resync path without a changelog or a pre-token ----------------------

class _NoChangelog:
    """A modeler that lists and keeps no changelog: no ``delta``, no
    ``token``."""

    def __init__(self, store):
        self._store = store

    def list(self):
        return self._store.list()


def _host(pkg: str, changelog: bool):
    """A ``BatchScheduler`` resync host of package ``pkg`` (the JAX
    package's or the port's), its modeler with or without a changelog."""
    import importlib

    tpu_batch = importlib.import_module(f"{pkg}.scheduler.tpu_batch")
    driver = importlib.import_module(f"{pkg}.scheduler.driver")
    cache = importlib.import_module(f"{pkg}.client.cache")
    incremental = importlib.import_module(f"{pkg}.models.incremental")
    metrics = importlib.import_module(f"{pkg}.util.metrics")
    B = tpu_batch.BatchScheduler
    host = SimpleNamespace(
        _delta_token=None, _ckpt=None, _ckpt_waves=0, checkpoint_every=2,
        _encoder=incremental.IncrementalEncoder(),
        _sx=metrics.slipstream_metrics())
    for m in ("_encode_incremental", "_replay_resync", "_maybe_checkpoint",
              "_debug_verify_replay"):
        setattr(host, m, getattr(B, m).__get__(host))
    modeler = driver.SimpleModeler(cache.FIFO(), cache.Store())
    host.scheduled = modeler.scheduled
    host.config = SimpleNamespace(
        modeler=modeler if changelog else _NoChangelog(modeler.scheduled))
    host.metrics = (metrics.slipstream_metrics(),
                    tpu_batch._wave_metrics())
    return host


def _counts(host):
    sx, wm = host.metrics
    return (sx.resync_full.value("no_changelog"),
            sx.resync_full.value("no_checkpoint"), sx.resync_full.total(),
            sx.resync_replay.total(), wm.resyncs.value())


def _arrays(snap):
    return {f.name: np.asarray(getattr(snap, f.name))
            for f in dataclasses.fields(snap)
            if isinstance(getattr(snap, f.name), np.ndarray)}


@pytest.mark.parametrize("case", ["no_changelog", "no_pre_token"])
def test_resync_without_changelog_or_pre_token_matches_reference(case):
    """Four waves, the scheduled pods of each added to the store before
    the next, and the delta cursor lost before the fourth: each wave's
    snapshot, the resync token's presence, the checkpoint's and the
    resync counters' moves equal the JAX package's."""
    from test_torch_batch_solver import PORT, REF

    hosts = {"kubernetes_tpu": (_host("kubernetes_tpu", case != "no_changelog"),
                                REF),
             "kubernetes_tpu_torch": (
                 _host("kubernetes_tpu_torch", case != "no_changelog"), PORT)}
    rng = np.random.RandomState(18)
    sizes = [int(s) for s in rng.randint(100, 900, size=16)]
    seen = {pkg: [] for pkg in hosts}
    nodes = {pkg: [kit.node(f"n{i}", cpu_m=8000) for i in range(3)]
             for pkg, (_h, kit) in hosts.items()}
    for w in range(4):
        for pkg, (host, kit) in hosts.items():
            if w == 3:
                host._delta_token = None
            pending = [kit.pod(f"w{w}p{i}", cpu_m=sizes[4 * w + i],
                               host_ports=(8000 + i,) if i == 0 else ())
                       for i in range(4)]
            before = _counts(host)
            # a plain list function: no pre_token attribute
            snap = host._encode_incremental(nodes[pkg], pending, [],
                                            host.scheduled.list)
            after = _counts(host)
            seen[pkg].append((
                _arrays(snap), host._delta_token is not None,
                host._ckpt is not None,
                tuple(a - b for a, b in zip(after, before))))
            for j, p in enumerate(pending):
                p.spec.host = p.status.host = f"n{j % 3}"
                host.scheduled.add(p)
    ref, port = seen["kubernetes_tpu"], seen["kubernetes_tpu_torch"]
    for w, (r, p) in enumerate(zip(ref, port)):
        assert r[0].keys() == p[0].keys()
        for k in r[0]:
            assert np.array_equal(r[0][k], p[0][k]), f"wave {w}: {k}"
        assert r[1:] == p[1:], f"wave {w}: {r[1:]} vs {p[1:]}"
    if case == "no_changelog":
        # every wave a full list sync counted as no_changelog, no token,
        # no checkpoint, no resyncs count
        assert [p[1:] for p in port] == [
            (False, False, (1, 0, 1, 0, 0))] * 4
    else:
        # birth full, two deltas, then a replay from the checkpoint
        assert [p[3] for p in port] == [
            (0, 1, 1, 0, 1), (0, 0, 0, 0, 0), (0, 0, 0, 0, 0),
            (0, 0, 0, 1, 0)]
        assert all(p[1] and p[2] for p in port)
