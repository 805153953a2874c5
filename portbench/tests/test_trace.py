"""The trace reduction and the readers of the device metrics, on a small
Chrome trace written by hand."""

import json

import pytest

from portbench import manifest, trace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.fixture
def traced(tmp_path):
    events = [
        _ev("portbench.wave", "user_annotation", 0, 1000),
        _ev("portbench.encode_snapshot", "user_annotation", 0, 600),
        _ev("portbench.solve", "user_annotation", 600, 390),
        _ev("aten::copy_", "cpu_op", 610, 20),
        _ev("aten::mm", "cpu_op", 960, 30),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 615, 10),
        _ev("void kgpu::commit_solve_kernel<int, false>(int*, int)",
            "kernel", 700, 250),
        _ev("portbench.wave", "user_annotation", 2000, 500),
        _ev("portbench.encode_snapshot", "user_annotation", 2000, 300),
        _ev("portbench.solve", "user_annotation", 2300, 200),
        _ev("void kgpu::commit_solve_kernel<int, false>(int*, int)",
            "kernel", 2350, 100),
        # outside every wave: not counted
        _ev("void at::native::reduce_kernel<512>(x)", "kernel", 1500, 50),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.read(path)


def test_reduction(traced):
    assert traced.waves == [(0.0, 1e-3), (2e-3, 2.5e-3)]
    assert traced.busy_s == pytest.approx([260e-6, 100e-6])
    assert traced.kernels == [{"commit_solve_kernel": pytest.approx(250e-6)},
                              {"commit_solve_kernel": pytest.approx(100e-6)}]
    # each gap goes to what the host was doing at its midpoint
    gaps = traced.idle_gaps
    assert gaps == {"encode_snapshot": pytest.approx(615e-6 + 350e-6),
                    "solve": pytest.approx(75e-6 + 50e-6),
                    "solve/aten::mm": pytest.approx(50e-6)}


def test_device_readers(traced):
    rec = {"trace": traced, "waves": [{}, {}], "compared": []}
    kernel = manifest.module("metrics", "kernel_ms").read(rec)
    assert kernel == pytest.approx(0.175)
    idle = manifest.module("metrics", "device_idle_pct").read(rec)
    assert idle == pytest.approx(100 * (1 - 360e-6 / 1.5e-3))
    # nothing compared: no roofline, never a 0
    assert manifest.module("metrics", "commit_solve_roofline").read(
        rec) is None


def test_no_trace_reads_nothing():
    rec = {"waves": [{}], "compared": []}
    for name in ("kernel_ms", "device_idle_pct", "commit_solve_roofline"):
        assert manifest.module("metrics", name).read(rec) is None


def test_kernel_names():
    assert trace.kernel_name(
        "void kgpu::commit_solve_cluster_kernel<int, 16>(int*)") == \
        "commit_solve_cluster_kernel"
    assert trace.kernel_name("void at::native::(anonymous namespace)::"
                             "reduce_kernel<512, 1>(R)") == "reduce_kernel"
