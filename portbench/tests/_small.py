"""Small seeded waves, for the CPU tests: the cell's own mix at a small
size; the same cluster with 8 services and one pod in ten asking a host
port, so that ServiceSpreading and PodFitsPorts have work; and PodGroups
of 8 (the generator kept for a later gang cell) with members large
enough that the cluster fills and groups roll back."""

from portbench import manifest
from portbench.generators._cluster import base_cluster

_PORTS = {"host_port_share": 0.1, "host_ports": [7000, 7049]}
SIZES = {
    "north_star.burst": {"config": {"nodes": 200},
                         "traffic": {"pods": 400, "compare_waves": 2}},
    "services": {"config": {"nodes": 200, "services": 8},
                 "traffic": {"pods": 400}, "mix": _PORTS},
    "gang": {"config": {"nodes": 100},
             "traffic": {"generator": "gang_burst", "groups": 40,
                         "group_size": 8},
             "mix": {"cpu_m": [100, 1500, 100]}},
}
NAMES = tuple(SIZES)


def cell(name):
    """-> (config, traffic, generator module) of ``name`` at its small
    size."""
    size = SIZES[name]
    c = manifest.cell("north_star.burst", size)
    traffic = dict(c.traffic, mix={**c.traffic["mix"],
                                   **size.get("mix", {})})
    if name == "services":
        c.config["resident_mix"] = {**c.config["resident_mix"], **_PORTS}
    return c.config, traffic, manifest.module("generators",
                                              traffic["generator"])


def waves(name, seed, n=2):
    """-> (base, [burst, ...]) of ``name`` at its small size."""
    config, traffic, gen = cell(name)
    base = base_cluster(config, seed)
    return base, [gen.wave(base, config, traffic, seed, i) for i in range(n)]
