"""BENCHMARK.json against the benchmark's contract, the imports under
portbench/, and the generators' draws."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

from portbench import manifest
from portbench.tests._small import NAMES, cell, waves

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = manifest.load()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in M["paths"])
    for word in M["command"]:
        assert "\n" not in word and 1 <= len(word) <= 200


def test_names_and_units_use_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    for w in M["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in M["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in M[group]}) == len(M[group])
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for w in M["workloads"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                assert w["name"] in e2e[m["moves"]].get(
                    "workloads", [w["name"]])


def test_every_file_is_found_by_name():
    root = manifest.ROOT
    for c in M["configs"]:
        assert (root / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in M["workloads"])
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
    for w in M["workloads"]:
        c = manifest.cell(w["name"])
        assert (manifest.HERE / "generators"
                / f"{c.traffic['generator']}.py").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_no_port_in_the_reference():
    files = sorted(manifest.HERE.rglob("*.py"))
    assert files
    for f in files:
        tops = set(_imports(f))
        assert not tops & {"jax", "jaxlib", "flax", "kubernetes_tpu"}, f
    for f in sorted((manifest.HERE / "reference").rglob("*.py")):
        tops = set(_imports(f))
        assert not tops & {"kubernetes_tpu_torch", "portbench", "torch"}, f


@pytest.mark.parametrize("name", NAMES)
def test_same_seed_same_objects(name):
    a_base, a = waves(name, 2**31 + 5)
    b_base, b = waves(name, 2**31 + 5)
    _, c = waves(name, 2**31 + 6)
    assert a_base.plain.res_cpu.tolist() == b_base.plain.res_cpu.tolist()
    for x, y in zip(a, b):
        assert [repr(p) for p in x.pods] == [repr(p) for p in y.pods]
        assert x.plain.keys == y.plain.keys
    assert a[0].plain.keys != a[1].plain.keys
    assert a[0].plain.keys != c[0].plain.keys


def test_the_cells_mix_is_scheduler_perfs_pod_template():
    config, traffic, _gen = cell("north_star.burst")
    base, bursts = waves("north_star.burst", 9)
    pl = base.plain
    assert len(base.residents) == config["nodes"] * 28
    assert set(np.bincount(pl.res_node).tolist()) == {28}
    assert set(pl.cap_cpu.tolist()) == {4000}
    assert set(pl.cap_mem.tolist()) == {32 << 30}
    assert not base.services and not any(n.metadata.labels
                                         for n in base.nodes)
    for pods, cpu, mem, port, svc in (
            (base.residents, pl.res_cpu, pl.res_mem, pl.res_port,
             pl.res_service),) + tuple(
            (b.pods, b.plain.cpu, b.plain.mem, b.plain.port,
             b.plain.service) for b in bursts):
        assert set(cpu.tolist()) == {100} and set(mem.tolist()) == {500 << 20}
        assert not port.any() and set(svc.tolist()) == {-1}
        for p in pods:
            c = p.spec.containers[0]
            assert c.resources.limits["cpu"].milli_value() == 100
            assert c.resources.limits["memory"].int_value() == 500 << 20
            assert [(cp.container_port, cp.host_port)
                    for cp in c.ports] == [(80, 0)]
            assert not p.metadata.labels


@pytest.mark.parametrize("name", ["services", "gang"])
def test_the_test_mixes_are_as_stated(name):
    config, traffic, _gen = cell(name)
    base, bursts = waves(name, 9)
    mi = 1 << 20
    lo, hi, step = traffic["mix"]["cpu_m"]
    for burst in bursts:
        w = burst.plain
        n = len(w.keys)
        assert set(w.cpu.tolist()) == set(range(lo, hi + 1, step))
        assert set(w.mem.tolist()) == {500 * mi}
        if name == "services":
            assert np.count_nonzero(w.port) == round(n / 10)
            assert set(w.port[w.port > 0].tolist()) <= set(range(7000, 7050))
            assert sorted(set(w.service.tolist())) == list(range(8))
        else:
            assert w.group.tolist() == np.repeat(np.arange(40), 8).tolist()
        # the objects say what the plain description says
        for p, c, m, port in zip(burst.pods, w.cpu, w.mem, w.port):
            lim = p.spec.containers[0].resources.limits
            assert lim["cpu"].milli_value() == c
            assert lim["memory"].int_value() == m
            got = [cp.host_port for cp in p.spec.containers[0].ports]
            assert got == [port]
    # residents of one node never share a host port
    pl = base.plain
    for node in range(config["nodes"]):
        ports = pl.res_port[pl.res_node == node]
        ports = ports[ports > 0]
        assert len(set(ports.tolist())) == len(ports)


def test_decimal_memory_is_drawn_when_asked():
    from portbench.generators._cluster import draw_mix, rng_for
    mix = dict(cell("north_star.burst")[1]["mix"],
               decimal_memory={"share": 0.1, "mb": [100, 1100, 200]})
    out = draw_mix(mix, 1000, 8, rng_for(1, 1))
    dec = out["mem_dec_mb"] > 0
    assert dec.sum() == 100
    assert set(out["mem"][dec].tolist()) == {m * 10**6
                                             for m in range(100, 1101, 200)}
