"""A run with the timed path broken underneath reads ``correct`` false,
once for each control and fault a cell can have (planted under
``batch_solver.solve`` by ``portbench.control``, as on the card); a sound
run reads it true. The harness's look for a card is skipped: the port
runs its plain version on the CPU, at a small size."""

import sys
import time
import types

import pytest

from portbench import control, harness, manifest
from portbench.tests._small import SIZES

NAME = "north_star.burst"


def _run(seconds=0.5):
    return harness.run_cell(NAME, 2**31 + 77, seconds, False,
                            time.perf_counter(), device="cpu",
                            overrides=SIZES[NAME], log=lambda _m: None)


def test_a_sound_run_is_correct():
    r = _run()
    assert r["correct"] is True
    assert r["checks"] == {"mismatched_pods": {"value": 0, "limit": 0}}
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"pods_per_s", "setup_s"}


@pytest.mark.parametrize("which", control.PLANTED)
def test_a_broken_timed_path_is_not_correct(which):
    with control.planted(which):
        r = _run()
    assert r["correct"] is False
    assert r["checks"]["mismatched_pods"]["value"] > 0
    assert r["failed"] == r["checks"]["mismatched_pods"]["value"]


def test_control_readings_at_a_small_size():
    r = control.readings(NAME, 3000000021, seeds=2, faults=1, seconds=0.5,
                         device="cpu", overrides=SIZES[NAME],
                         log=lambda _m: None)
    assert [x["mismatched_pods"] for x in r["program"]] == [0, 0]
    for which in control.PLANTED:
        assert r[which][0]["mismatched_pods"] > 0, which
        assert r[which][0]["correct"] is False


def test_a_run_that_loads_jax_is_not_correct(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.setitem(sys.modules, "kubernetes_tpu.models", sys)
    r = _run(seconds=0.1)
    assert r["correct"] is False
    assert r["forbidden_modules"] == ["jax", "kubernetes_tpu"]


def test_a_metric_reader_that_loads_jax_is_caught(monkeypatch):
    # the look at sys.modules comes after every reader has run
    real = manifest.module

    def module(kind, name):
        mod = real(kind, name)
        if kind == "metrics":
            read = mod.read

            def reading(rec):
                monkeypatch.setitem(sys.modules, "jaxlib",
                                    types.ModuleType("jaxlib"))
                return read(rec)
            mod.read = reading
        return mod

    monkeypatch.setattr(manifest, "module", module)
    r = _run(seconds=0.1)
    assert r["correct"] is False
    assert r["forbidden_modules"] == ["jaxlib"]


def test_the_cli_refuses_to_run_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from portbench import run
    assert run.main(["--workload", NAME, "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
