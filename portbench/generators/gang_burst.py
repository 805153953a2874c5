"""Bursts of new PodGroups: ``groups`` groups of ``group_size`` members a
wave, each member drawn from the traffic's ``mix``, the members of a group
handed over together. A group rolls back only where the cluster is too
full to hold it whole."""

from __future__ import annotations

import numpy as np

from portbench.generators._cluster import (Base, Burst, draw_mix,
                                           make_pods, rng_for)


def wave(base: Base, config: dict, traffic: dict, seed: int,
         index: int) -> Burst:
    G, size = traffic["groups"], traffic["group_size"]
    n = G * size
    mix = draw_mix(traffic["mix"], n, config["services"],
                   rng_for(seed, 1, index + 1))
    tag = "warm" if index < 0 else f"w{index}"
    group = np.repeat(np.arange(G), size)
    names = [f"{tag}-g{i // size:04d}-m{i % size}" for i in range(n)]
    uids = [f"{seed}-{tag}-g{i // size:04d}-m{i % size}" for i in range(n)]
    group_names = [f"job-{seed}-{tag}-g{g:04d}" for g in range(G)]
    return make_pods(base, mix, names, uids, group, group_names, size)
